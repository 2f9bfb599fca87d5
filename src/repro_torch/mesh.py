"""A named grid of devices with an ambient context: the port's counterpart of
``repro.compat``'s ``make_mesh``, ``set_mesh``, ``current_mesh`` and
``axis_size``.

The reference's mesh is a ``jax.sharding.Mesh`` that ``shard_map`` maps a
function over. The port keeps the idiom of :mod:`repro_torch.core.distributed`:
one process walks the grid's positions in order, each position's work runs
on that position's ``torch.device``, and a ``psum`` over an axis becomes a
sum in position order on the first position's device. No
``torch.distributed`` process group is used, so a grid may repeat a device:
``make_mesh(shape, names)`` without devices puts every position on the
default card, as XLA's forced host devices are all views of one CPU. A grid
of distinct cards takes the same path; that placement is unverified (the
port has been run on one H100 only).

A 1-D mesh iterates as its list of devices, so it is accepted wherever
:mod:`repro_torch.core.distributed` and the sharded searcher take a list of
shard devices.

Counting hooks. The port's position loops (the shard loops of
:mod:`repro_torch.core.distributed`, the data-shard loop of
``make_shardmap_train_step``, the (i, j) loop of ``moe_apply_manual``) run
each position's work under :func:`position` (through :func:`walk`), and the
places where data crosses positions report their payload to :func:`tally`.
Both do nothing unless a counter is active (:func:`counting`, used by
:mod:`repro_torch.launch.op_analysis`): results and launches are the same
either way. A walk given ``enter`` also places the backward pass of each
position's work at that position, and :func:`recompute_context` places a
checkpointed region's recomputation where its forward ran.

Partition specs. :class:`P` is the port's ``jax.sharding.PartitionSpec``;
:func:`local_shape` and :func:`block` give the shape and the block of a
tensor that one position holds under a spec, tiled as ``NamedSharding``
tiles it.
"""
from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import math

import numpy as np
import torch

from repro_torch.utils import resolve_device


@dataclasses.dataclass(frozen=True, eq=False)
class DeviceMesh:
    """``devices`` is a numpy object array of ``torch.device`` whose shape is
    the mesh's; ``axis_names`` names its axes in order."""

    devices: np.ndarray
    axis_names: tuple[str, ...]

    def __post_init__(self):
        if self.devices.ndim != len(self.axis_names) or len(set(self.axis_names)) != len(
                self.axis_names):
            raise ValueError(f"axis names {self.axis_names} do not name the axes of a "
                             f"{self.devices.shape} grid once each")

    @property
    def shape(self) -> dict[str, int]:
        """Axis name -> size, in axis order (as ``jax.sharding.Mesh.shape``)."""
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def __iter__(self):
        if self.devices.ndim != 1:
            raise ValueError(f"a {self.shape} mesh is not a list of devices; only a 1-D mesh is")
        return iter(self.devices.tolist())

    def grid(self, *groups) -> np.ndarray:
        """The devices as a grid with one axis per group of axis names (a
        group's axes flattened in the order given, as a ``PartitionSpec``
        entry of several axes is), at position 0 of every axis in no group:
        work the reference replicates over an axis is done once."""
        groups = [(g,) if isinstance(g, str) else tuple(g) for g in groups]
        named = [n for g in groups for n in g]
        unknown = [n for n in named if n not in self.axis_names]
        if unknown or len(set(named)) != len(named):
            raise ValueError(f"axes {named} are not distinct axes of the mesh {self.shape}")
        rest = [n for n in self.axis_names if n not in named]
        arr = np.transpose(self.devices, [self.axis_names.index(n) for n in named + rest])
        arr = arr[(Ellipsis,) + (0,) * len(rest)] if rest else arr
        return arr.reshape([axis_size(self, g) for g in groups])

    def coords(self, groups, index) -> dict[str, int]:
        """The axis coordinates of position ``index`` (one entry a group) of
        :meth:`grid` over ``groups``: a group's flat index unravelled over its
        axes in the order given, ``{axis name: index}``."""
        out = {}
        for g, i in zip(groups, index):
            names = (g,) if isinstance(g, str) else tuple(g)
            sizes = [self.shape[n] for n in names]
            out.update(zip(names, (int(c) for c in np.unravel_index(int(i), sizes))))
        return out


# ------------------------------------------------------------ partitions --
def _spec_entry(entry):
    if entry is None or isinstance(entry, str):
        return entry
    names = tuple(entry)
    if not all(isinstance(n, str) for n in names):
        raise TypeError(f"a partition spec entry names mesh axes; got {entry!r}")
    return None if not names else names[0] if len(names) == 1 else names


class P(tuple):
    """A partition spec, as ``jax.sharding.PartitionSpec``: one entry a
    dimension, each ``None`` (not split), a mesh axis name, or a tuple of
    names (split over their flattened product, row-major in the order
    given); dimensions past the last entry are not split. As in jax, a
    one-name tuple is that name and an empty one is None."""

    def __new__(cls, *entries):
        return super().__new__(cls, tuple(_spec_entry(e) for e in entries))

    def __getnewargs__(self):
        return tuple(self)

    def __repr__(self):
        return "P(" + ", ".join(repr(e) for e in self) + ")"


def entry_axes(entry) -> tuple[str, ...]:
    """The mesh axes one spec entry names, in order (none for None)."""
    return () if entry is None else (entry,) if isinstance(entry, str) else tuple(entry)


def _full_spec(shape, spec) -> tuple:
    spec = tuple(spec)
    if len(spec) > len(shape):
        raise ValueError(f"a spec of {len(spec)} entries {spec} for a {len(shape)}-d shape")
    return spec + (None,) * (len(shape) - len(spec))


def local_shape(shape, spec, mesh: DeviceMesh) -> tuple[int, ...]:
    """The shape of one position's block of a ``shape`` tensor split by
    ``spec`` over ``mesh``: each dimension divided by the size of the axes
    its entry names, rounded up (as XLA pads a split that does not divide;
    the specs the port places, :func:`repro_torch.launch.sharding.sanitize_specs`
    ones, always divide)."""
    return tuple(-(-int(size) // axis_size(mesh, entry)) if entry is not None else int(size)
                 for size, entry in zip(shape, _full_spec(shape, spec)))


def block_slices(shape, spec, mesh: DeviceMesh, coords: dict) -> tuple[slice, ...]:
    """The index of position ``coords``' block (``{axis name: index}``; it
    must name every axis the spec does): along a split dimension the
    position's index over the entry's axes, row-major in the entry's order,
    picks one of the equal pieces."""
    out = []
    for size, entry, n in zip(shape, _full_spec(shape, spec), local_shape(shape, spec, mesh)):
        axes = entry_axes(entry)
        if not axes:
            out.append(slice(None))
            continue
        i = int(np.ravel_multi_index([coords[a] for a in axes], [mesh.shape[a] for a in axes]))
        out.append(slice(min(i * n, int(size)), min((i + 1) * n, int(size))))
    return tuple(out)


def block(tensor: torch.Tensor, spec, mesh: DeviceMesh, coords: dict) -> torch.Tensor:
    """Position ``coords``' block of ``tensor`` under ``spec`` (a view), as
    ``NamedSharding(mesh, spec)`` tiles it."""
    return tensor[block_slices(tensor.shape, spec, mesh, coords)]


def make_mesh(shape, names, devices=None) -> DeviceMesh:
    """A mesh of ``shape`` named ``names`` over the first ``prod(shape)`` of
    ``devices`` in row-major order; like ``jax.make_mesh`` it raises when
    fewer are given. Without ``devices`` every position is the default card
    (the counterpart of XLA's forced host devices); a device may repeat."""
    shape, names = tuple(int(s) for s in shape), tuple(names)
    need = math.prod(shape)
    if devices is None:
        card = resolve_device("cuda")
        if card.type == "cuda" and card.index is None:
            card = torch.device("cuda", torch.cuda.current_device())
        devices = [card] * need
    devices = [torch.device(d) for d in devices]
    if len(devices) < need:
        raise ValueError(f"Number of devices {len(devices)} must be >= the product of "
                         f"mesh_shape {shape}")
    arr = np.empty(need, dtype=object)
    arr[:] = devices[:need]
    return DeviceMesh(arr.reshape(shape), names)


def position_slice(mesh: DeviceMesh, axes, coords: dict | None = None) -> DeviceMesh:
    """``mesh`` cut to one index of each of ``axes`` (kept, of size 1): the
    slice of the grid one position's block of the batch runs over, at
    ``coords`` (``{axis name: index}``; default index 0 of each)."""
    coords = coords or {}
    cut = tuple(slice(coords.get(n, 0), coords.get(n, 0) + 1) if n in axes else slice(None)
                for n in mesh.axis_names)
    return DeviceMesh(mesh.devices[cut], mesh.axis_names)


_AMBIENT: contextvars.ContextVar[DeviceMesh | None] = contextvars.ContextVar(
    "repro_torch_mesh", default=None)


def current_mesh() -> DeviceMesh | None:
    """The mesh installed by :func:`set_mesh`, or None."""
    return _AMBIENT.get()


@contextlib.contextmanager
def set_mesh(mesh: DeviceMesh):
    """``with set_mesh(mesh):`` makes ``mesh`` the ambient mesh (what
    ``moe_impl="manual"`` runs over) in this context and thread."""
    token = _AMBIENT.set(mesh)
    try:
        yield mesh
    finally:
        _AMBIENT.reset(token)


def axis_size(mesh: DeviceMesh, name) -> int:
    """The size of axis ``name``, or the product over a tuple of names."""
    names = (name,) if isinstance(name, str) else tuple(name)
    missing = [n for n in names if n not in mesh.axis_names]
    if missing:
        raise ValueError(f"axes {missing} are not in the mesh {mesh.shape}")
    return math.prod(mesh.shape[n] for n in names)


# ------------------------------------------------------------ counting ----
_COUNTER: contextvars.ContextVar = contextvars.ContextVar("repro_torch_counter", default=None)


@contextlib.contextmanager
def counting(counter):
    """Make ``counter`` the active one in this context and thread. It holds
    the current coordinates in ``coords`` (on the counter, not in this
    context, so that work autograd runs on its own thread is placed too)
    and takes ``add(coords, flops, nbytes)``, ``add_collective(coords,
    kind, nbytes)``, ``suspended()``, ``replay(coords, entry)`` and the
    ``recorders`` list :func:`walk` uses (each a dict of the entries
    counted while it is listed, by coordinates); its ``represent``
    attribute lets :func:`walk` run one position of a class of equal ones."""
    token = _COUNTER.set(counter)
    try:
        yield counter
    finally:
        _COUNTER.reset(token)


def counting_active() -> bool:
    """Whether a counter is active in this context (:func:`counting`)."""
    return _COUNTER.get() is not None


@contextlib.contextmanager
def position(**coords):
    """Attribute the work in this context to the positions whose
    coordinates agree with ``coords`` (axes not named: every index). Nested
    positions merge, an axis the enclosing position already fixes keeping
    its index: a walk inside a walk over the same axes (the manual MoE's
    data blocks inside a train step's data shard) counts each op at one set
    of coordinates. Does nothing unless a counter is active."""
    counter = _COUNTER.get()
    if counter is None:
        yield
        return
    outer = counter.coords
    counter.coords = tuple(sorted({**{a: int(i) for a, i in coords.items()},
                                   **dict(outer)}.items()))
    try:
        yield
    finally:
        counter.coords = outer


def tally(kind: str, nbytes: int) -> None:
    """Report ``nbytes`` crossing positions in one collective of ``kind``
    (``all-reduce``, ``all-gather``; the payload one position sends or
    receives, as ``hlo_analysis`` reads an op's output shape) at the
    current position. Does nothing unless a counter is active."""
    counter = _COUNTER.get()
    if counter is not None:
        counter.add_collective(counter.coords, kind, int(nbytes))


def deferred_tally():
    """A :func:`tally` bound to the active counter, for a backward pass
    (which may run on autograd's own thread): called later, it counts at
    the counter's coordinates then. Does nothing unless a counter was
    active."""
    counter = _COUNTER.get()
    if counter is None:
        return None
    return lambda kind, nbytes: counter.add_collective(counter.coords, kind, int(nbytes))


def uncounted():
    """A context manager factory bound to the active counter, under which
    nothing is counted (for a hook autograd may run on a thread of its
    own); a null context without a counter."""
    counter = _COUNTER.get()
    return contextlib.nullcontext if counter is None else counter.suspended


def tensor_bytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def walk(n: int, coords, fn, inputs=None, *, enter=None) -> list:
    """``[fn(i) for i in range(n)]``, call i under ``position(**coords(i))``.

    ``coords(i)`` gives position i's coordinates; it is called only while a
    counter is active, so a walk costs its calls alone otherwise. Under a
    counter whose ``represent`` is set the walk may run one representative
    position of a class of equal ones: where ``inputs(i)`` gives ``meta``
    tensors (which carry no values, so no op can depend on data) of the
    same shapes and dtypes at every i, ``fn`` runs for index 0 only; every
    other index gets call 0's result and call 0's counts, re-addressed from
    position 0's coordinates to its own. Where call 0's result requires a
    gradient, the backward pass it would take later runs outside the walk
    and cannot be represented, so every position runs. The caller
    guarantees that ``fn`` does not branch on i beyond indexing its
    inputs. Otherwise every position runs.

    With ``enter``, call i is ``fn(i, *enter(i))``: ``enter(i)`` gives the
    tensors position i takes from work outside it. Under a counter, while
    gradients are taken, autograd runs the backward pass of call i's work
    (from its outputs back to those tensors) at position i's coordinates,
    and the work outside the walk's positions at the walk's own: each is
    marked by an identity node (:class:`_Leave` on the outputs,
    :class:`_Arrive` on the entered tensors) whose backward sets the
    coordinates. This relies on autograd running a graph's nodes in the
    reverse order of their creation where the dependencies allow it (its
    ready queue is ordered by sequence number), so that one position's
    backward nodes run together."""
    counter = _COUNTER.get()
    if enter is not None:
        fn = _entering(counter, fn, enter)
    if counter is None:
        return [fn(i) for i in range(n)]
    if (not counter.represent or n < 2 or inputs is None
            or not _equal_meta_inputs(inputs, n)):
        out = []
        for i in range(n):
            with position(**coords(i)):
                out.append(fn(i))
        return out
    outer = dict(counter.coords)
    with position(**coords(0)):
        first, recorder = _traced(counter, lambda: fn(0))
    if _requires_grad(first):
        out = [first]
        for i in range(1, n):
            with position(**coords(i)):
                out.append(fn(i))
        return out
    base = {**coords(0), **outer}
    for i in range(1, n):
        here = {**coords(i), **outer}
        moved = {a: here[a] for a in base if here[a] != base[a]}
        for key, entry in list(recorder.items()):
            counter.replay(tuple(sorted({**dict(key), **moved}.items())), entry)
        counter.represented += 1
    return [first] * n


def _entering(counter, fn, enter):
    """``i -> fn(i, *enter(i))``, marked for the backward pass under a
    counter while gradients are taken (:func:`walk`)."""
    if counter is None or not torch.is_grad_enabled():
        return lambda i: fn(i, *enter(i))
    outer = counter.coords

    def call(i):
        ins = [_Arrive.apply(counter, outer, t) if _requires_grad(t) else t for t in enter(i)]
        out = fn(i, *ins)
        return _mark(out, lambda t: _Leave.apply(counter, counter.coords, t))
    return call


def _mark(value, mark):
    if isinstance(value, torch.Tensor):
        return mark(value) if value.requires_grad else value
    if isinstance(value, (list, tuple)):
        return type(value)(_mark(v, mark) for v in value)
    return value


class _Leave(torch.autograd.Function):
    """Identity on a position's output; its backward runs the position's
    backward work at the position's coordinates (:func:`walk`)."""

    @staticmethod
    def forward(ctx, counter, coords, x):
        ctx.counter, ctx.coords = counter, coords
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        ctx.counter.coords = ctx.coords
        return None, None, grad


class _Arrive(torch.autograd.Function):
    """Identity on a tensor entering a position; its backward returns to
    the coordinates outside the position (:func:`walk`)."""

    @staticmethod
    def forward(ctx, counter, coords, x):
        ctx.counter, ctx.coords = counter, coords
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        ctx.counter.coords = ctx.coords
        return None, None, grad


@contextlib.contextmanager
def _at_coords(counter, coords):
    outer = counter.coords
    counter.coords = coords
    try:
        yield
    finally:
        counter.coords = outer


@contextlib.contextmanager
def backward_pass():
    """Around ``torch.autograd.grad``: the coordinates are the enclosing
    ones again once the backward pass is done, whichever position's
    identity node (:func:`walk`) ran last. Does nothing unless a counter is
    active."""
    counter = _COUNTER.get()
    if counter is None:
        yield
        return
    with _at_coords(counter, counter.coords):
        yield


@contextlib.contextmanager
def _recomputing(counter, coords):
    token = _COUNTER.set(counter)
    try:
        with _at_coords(counter, coords):
            yield
    finally:
        _COUNTER.reset(token)


def recompute_context():
    """A ``context_fn`` for ``torch.utils.checkpoint`` (non-reentrant): the
    region's recomputation in the backward pass counts at the coordinates
    its forward ran at (and the walks inside it at their positions), not at
    those of the backward node that asks for it, with the counter active
    in the thread autograd recomputes on (a card's backward pass runs on a
    thread of its own). Does nothing unless a counter is active."""
    counter = _COUNTER.get()
    if counter is None:
        return contextlib.nullcontext(), contextlib.nullcontext()
    return contextlib.nullcontext(), _recomputing(counter, counter.coords)


def _requires_grad(value) -> bool:
    if isinstance(value, torch.Tensor):
        return value.requires_grad
    if isinstance(value, dict):
        value = list(value.values())
    return isinstance(value, (list, tuple)) and any(_requires_grad(v) for v in value)


def _equal_meta_inputs(inputs, n: int) -> bool:
    first = None
    for i in range(n):
        ts = list(inputs(i))
        if not ts or any(t.device.type != "meta" for t in ts):
            return False
        sig = [(tuple(t.shape), t.dtype) for t in ts]
        if first is None:
            first = sig
        elif sig != first:
            return False
    return True


@contextlib.contextmanager
def one_pass():
    """Count the work in this context as one pass over the tensors handed
    to the yielded ``moves(*tensors)`` (inputs read once, outputs written
    once) in place of its ops: for a function whose ops depend on the data
    (``nonzero``), so that a count on the card and one on meta tensors,
    which cannot run those ops, agree; and for the port's sum of the
    positions' parts, which stands for a collective. Does nothing unless a
    counter is active."""
    counter = _COUNTER.get()
    if counter is None:
        yield lambda *tensors: None
        return
    moved: list = []
    with counter.suspended():
        yield lambda *tensors: moved.extend(tensors)
    counter.add(counter.coords, 0, tensor_bytes(*moved))


def scan(core, n: int, carry, seqs=(), consts=()):
    """The sequential loop ``y_t, carry = core(*[x[:, t] for x in seqs],
    carry, *consts)`` for t < n; returns ([y_t], carry).

    Under a counter whose ``represent`` is set, on ``meta`` tensors (no
    values, so every step's ops repeat while the carry keeps its shape),
    one step is traced and the others are given its counts: without
    gradients step 0 runs and the rest reuse its result; with gradients the
    whole loop is one node of :class:`_RepresentedScan`, whose forward
    traces step 0 and whose backward traces each step's backward once for
    each signature (which gradients flow) and replays it for the other
    steps, and counts what autograd does around the steps of the written
    loop: each step's slice of a sequence handed its gradient
    (``select_backward``) and the steps' gradients of each sequence and
    each constant added up one by one. ``core`` must not branch on anything
    but its inputs' shapes. Otherwise every step runs as written."""
    counter = _COUNTER.get()
    if counter is None or not counter.represent or n < 2 or not carry.is_meta:
        ys = []
        for t in range(n):
            y, carry = core(*[x[:, t] for x in seqs], carry, *consts)
            ys.append(y)
        return ys, carry
    if torch.is_grad_enabled():
        state = {"core": core, "counter": counter, "n": n, "k": len(seqs)}
        outs = _RepresentedScan.apply(state, *seqs, carry, *consts)
        counter.represented_steps += n - 1
        return list(outs[:n]), outs[n]
    (y, after), recorder = _traced(counter, lambda: core(*[x[:, 0] for x in seqs], carry,
                                                          *consts))
    if (after.shape, after.dtype) != (carry.shape, carry.dtype):
        raise ValueError("scan: the carry changed its shape, so the steps are not equal")
    _replay(counter, recorder, n - 1)
    counter.represented_steps += n - 1
    return [y] * n, after


def _replay(counter, recorder: dict, times: int = 1) -> None:
    """The entries of ``recorder`` counted ``times`` more times."""
    if times <= 0:
        return
    for key, entry in list(recorder.items()):
        if times > 1:
            entry = {"flops": entry["flops"] * times, "bytes": entry["bytes"] * times,
                     **{k: {kind: v * times for kind, v in entry[k].items()}
                        for k in ("collective_bytes", "collective_counts")}}
        counter.replay(key, entry)


def _traced(counter, fn):
    """(fn()'s result, the entries counted while it ran)."""
    recorder: dict = {}
    counter.recorders.append(recorder)
    try:
        out = fn()
    finally:
        # by identity: a nested walk's recorder may equal this one in value
        at = next(i for i, r in enumerate(counter.recorders) if r is recorder)
        del counter.recorders[at]
    return out, recorder


def _empty_like_spec(spec):
    return None if spec is None else torch.empty(spec[0], dtype=spec[1], device="meta")


def _spec_of(t):
    return None if t is None else (tuple(t.shape), t.dtype)


class _RepresentedScan(torch.autograd.Function):
    """:func:`scan` under gradients on meta tensors as one node: the forward
    traces step 0 and replays its counts for the others, returning empty
    meta tensors of its outputs' shapes; the backward walks the steps from
    the last, tracing each signature's backward once (the step's own
    vector-Jacobian product, its forward recomputed uncounted) and
    replaying it for the other steps, then counts, for each sequence and
    constant that takes a gradient, what autograd runs around the written
    loop's steps: a ``select_backward`` of each step's gradient of a
    sequence's slice, and the additions that sum the steps' gradients of an
    input one by one."""

    @staticmethod
    def forward(ctx, state, *tensors):
        ctx.state = state
        ctx.save_for_backward(*tensors)
        ctx.set_materialize_grads(False)
        counter, n, k = state["counter"], state["n"], state["k"]
        seqs, carry, consts = tensors[:k], tensors[k], tensors[k + 1:]
        (y, after), rec = _traced(counter, lambda: state["core"](*[x[:, 0] for x in seqs],
                                                                  carry, *consts))
        if (after.shape, after.dtype) != (carry.shape, carry.dtype):
            raise ValueError("scan: the carry changed its shape, so the steps are not equal")
        _replay(counter, rec, n - 1)
        # the other steps' outputs: views of one empty tensor (free)
        rest = torch.empty((n - 1, *y.shape), dtype=y.dtype, device="meta").unbind(0)
        return (y, *rest, _empty_like_spec(_spec_of(after)))

    @staticmethod
    def backward(ctx, *grads):
        state = ctx.state
        counter, n, k = state["counter"], state["n"], state["k"]
        tensors = ctx.saved_tensors
        seqs, carry, consts = tensors[:k], tensors[k], tensors[k + 1:]
        needs = ctx.needs_input_grad[1:]
        # the carry into step t > 0 is step t - 1's output: it takes a
        # gradient where any input does
        chain = any(needs)
        traced: dict = {}  # signature -> (counts, gradient specs, steps)
        got = [0] * len(tensors)  # the steps that gave each input a gradient
        # the gradient handed back to step t's carry output: the caller's for
        # the last step, the next step's carry input's before it (a spec
        # stands for a tensor, which only step 0's is made for)
        g_carry = _spec_of(grads[n])
        for t in range(n - 1, -1, -1):
            step_needs = (*needs[:k], needs[k] if t == 0 else chain, *needs[k + 1:])
            if grads[t] is None and g_carry is None:
                continue
            key = (grads[t] is not None, g_carry is not None, step_needs)
            if key not in traced:
                pair = (grads[t], grads[n] if t == n - 1 else _empty_like_spec(g_carry))
                ins = [x[:, t] for x in seqs] + [carry] + list(consts)
                gins, rec = _traced(counter, lambda: _step_vjp(state, counter, ins, step_needs,
                                                               pair))
                traced[key] = [rec, [_spec_of(g) for g in gins], 0]
            else:
                traced[key][2] += 1
            specs = traced[key][1]
            for i, sp in enumerate(specs):
                got[i] += sp is not None
            g_carry = specs[k]
        for rec, _, more in traced.values():
            _replay(counter, rec, more)
        out = []
        for i, x in enumerate(tensors):
            if i == k:
                out.append(_empty_like_spec(g_carry) if needs[k] else None)
                continue
            if not needs[i] or not got[i]:
                out.append(None)
                continue
            if i < k:  # each step's slice gradient placed into the sequence's shape
                grad = torch.empty((x.shape[0], *x.shape[2:]), dtype=x.dtype, device="meta")
                _repeat(counter, got[i], lambda: torch.ops.aten.select_backward(
                    grad, list(x.shape), 1, 0))
            total = torch.empty(x.shape, dtype=x.dtype, device="meta")
            _repeat(counter, got[i] - 1, lambda: total + total)
            out.append(total)
        return (None, *out)


def _step_vjp(state, counter, ins, needs, grads):
    """One step's vector-Jacobian product with respect to the inputs that
    ``needs`` marks, its forward recomputed uncounted."""
    with torch.enable_grad():
        ins = [t.detach().requires_grad_(need) for t, need in zip(ins, needs)]
        with counter.suspended():
            outs = state["core"](*ins)
        wrt = [i for i in ins if i.requires_grad]
        pairs = [(o, g) for o, g in zip(outs, grads) if g is not None]
        got = iter(torch.autograd.grad([o for o, _ in pairs], wrt, [g for _, g in pairs],
                                       allow_unused=True))
        return [next(got) if need else None for need in needs]


def _repeat(counter, times: int, fn) -> None:
    """``fn``'s counts ``times`` times: traced once, replayed for the rest."""
    if times <= 0:
        return
    _, rec = _traced(counter, fn)
    _replay(counter, rec, times - 1)
