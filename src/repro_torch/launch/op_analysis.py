"""Per-position flops, bytes and collective payloads of eager PyTorch code:
the port's counterpart of ``repro.launch.hlo_analysis``.

This is no HLO parser: eager torch has no compiled module to read. An
:class:`OpCounter` is a ``TorchDispatchMode`` that sees every ATen op the
code under it runs (on ``meta`` tensors, which have shapes and no storage,
or on the card) and adds to the position the op runs at
(:func:`repro_torch.mesh.position`, entered by the port's position loops):

  * flops  — matrix products only, through ``torch.utils.flop_counter``'s
             registry (mm, addmm, bmm, baddbmm, convolutions, attention),
             as ``hlo_analysis`` counts dots only, so elementwise work is
             left out;
  * bytes  — every input and output tensor of each op that moves memory;
             views, reshapes without a copy, ``detach``, ``alias`` and
             allocation without a write are free, as ``_FREE_OPS`` makes
             them in the reference (an in-place op reads and writes its
             first argument: both count);
  * collectives — the payloads the port reports where data crosses
             positions (:func:`repro_torch.mesh.tally`), by kind.

Work done outside any position is work the port does once; it counts for
every position, since the reference replicates it. A position's total is
everything whose coordinates agree with it, and the per-device figure is
the largest total over the mesh (:meth:`OpCounter.analysis`, keys as
``hlo_analysis.analyze`` gives them).

    with OpCounter(mesh) as counter:
        step(...)
    counter.analysis()["flops"]
"""
from __future__ import annotations

import contextlib
import itertools

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from repro_torch.mesh import DeviceMesh, counting

COLLECTIVE_KINDS = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
                    "collective-permute")

_aten = torch.ops.aten
#: ops that move no memory beyond what a view would (the reference's
#: ``_FREE_OPS``: parameter, bitcast, reshape, tuple plumbing)
_FREE = {_aten.detach, _aten.alias, _aten.lift_fresh, _aten._unsafe_view, _aten.view,
         _aten._reshape_alias, _aten.empty, _aten.empty_like, _aten.empty_strided,
         _aten.new_empty, _aten.new_empty_strided, _aten.sym_size, _aten.sym_stride,
         _aten.sym_numel, _aten.sym_storage_offset, _aten.is_same_size}


def _free(func) -> bool:
    return func.is_view or func._overloadpacket in _FREE


def _leaves(*values) -> list:
    """The arguments of an ATen op flattened one level (a list argument's
    items; aten ops nest no deeper), kwargs' values included."""
    out = []
    for v in values:
        if isinstance(v, dict):
            v = list(v.values())
        if isinstance(v, (list, tuple)):
            for x in v:
                out.extend(x) if isinstance(x, (list, tuple)) else out.append(x)
        else:
            out.append(v)
    return out


def _bytes(leaves) -> int:
    return sum(t.numel() * t.element_size() for t in leaves if isinstance(t, torch.Tensor))


def _spec(t):
    return (tuple(t.shape), t.stride(), t.dtype) if isinstance(t, torch.Tensor) else t


def _key(v):
    """A leaf's part of a signature: a tensor's metadata, or any other
    value with its type (``0``, ``0.0`` and ``False`` are equal in Python
    but give ``aten.full`` three dtypes)."""
    return (torch.Tensor, _spec(v)) if isinstance(v, torch.Tensor) else (type(v), v)


def _rebuild(spec):
    return (torch.empty_strided(spec[0], spec[1], dtype=spec[2], device="meta")
            if isinstance(spec, tuple) else spec)


def _signature(leaves):
    """What a meta kernel's output can depend on: each tensor's shape,
    strides and dtype, every other argument's type and value."""
    return tuple(_key(v) for v in leaves)


def _entry() -> dict:
    return {"flops": 0, "bytes": 0, "collective_bytes": {}, "collective_counts": {}}


def _merge(dst: dict, src: dict) -> None:
    dst["flops"] += src["flops"]
    dst["bytes"] += src["bytes"]
    for key in ("collective_bytes", "collective_counts"):
        for kind, v in src[key].items():
            dst[key][kind] = dst[key].get(kind, 0) + v


class OpCounter(TorchDispatchMode):
    """Counts the ops run under it by position of ``mesh``.

    ``represent=True`` lets the position loops trace one representative
    position of a class of equal ones (:func:`repro_torch.mesh.walk`: only
    on meta tensors whose shapes agree at every position) and give the
    others its counts, and lets a sequential scan run without gradients
    trace its first step (:func:`repro_torch.mesh.scan`);
    :attr:`represented` and :attr:`represented_steps` then count the walk
    positions and scan steps given a representative's counts without
    being traced."""

    def __init__(self, mesh: DeviceMesh, *, represent: bool = False):
        super().__init__()
        self.mesh = mesh
        self.represent = represent
        self.coords: tuple = ()
        self.recorders: list[dict] = []
        self.entries: dict[tuple, dict] = {}
        self.ops = 0
        self.represented = 0
        self.represented_steps = 0
        self._paused = 0
        self._scope = None
        self._meta_outputs: dict = {}

    def __enter__(self):
        self._scope = contextlib.ExitStack()
        self._scope.enter_context(counting(self))
        return super().__enter__()

    def __exit__(self, *exc):
        try:
            return super().__exit__(*exc)
        finally:
            self._scope.close()

    def _run(self, func, args, kwargs, leaves):
        """``func(*args, **kwargs)``; on meta tensors a functional op's
        outputs are made from the metadata its first call with the same
        signature gave (a meta kernel is a pure function of its inputs'
        metadata, and the Python ones are slow)."""
        if (func.is_view or func._schema.is_mutable
                or any(r.alias_info for r in func._schema.returns)
                or not all(t.is_meta for t in leaves if isinstance(t, torch.Tensor))):
            return func(*args, **kwargs)
        try:
            key = (func, _signature(leaves))
            hash(key)
        except TypeError:
            return func(*args, **kwargs)
        spec = self._meta_outputs.get(key)
        if spec is None:
            out = func(*args, **kwargs)
            outs = out if isinstance(out, (tuple, list)) else [out]
            if all(o.is_meta if isinstance(o, torch.Tensor) else not isinstance(o, (tuple, list))
                   for o in outs):  # a creation op may make a CPU tensor: never cached
                self._meta_outputs[key] = ((type(out), [_spec(o) for o in out])
                                           if isinstance(out, (tuple, list)) else
                                           (None, _spec(out)))
            return out
        kind, outs = spec
        if kind is None:
            return _rebuild(outs)
        return kind(_rebuild(o) for o in outs)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        leaves = _leaves(args, kwargs)
        out = self._run(func, args, kwargs, leaves)
        if self._paused:
            return out
        self.ops += 1
        packet = func._overloadpacket
        flops = int(flop_registry[packet](*args, **kwargs, out_val=out)) \
            if packet in flop_registry else 0
        nbytes = 0 if _free(func) else _bytes(leaves) + _bytes(_leaves(out))
        if flops or nbytes:
            self.add(self.coords, flops, nbytes)
        return out

    # -- the hooks repro_torch.mesh calls ---------------------------------
    def _targets(self, coords: tuple):
        yield self.entries.setdefault(coords, _entry())
        for rec in self.recorders:
            yield rec.setdefault(coords, _entry())

    def add(self, coords: tuple, flops: int, nbytes: int) -> None:
        for e in self._targets(coords):
            e["flops"] += flops
            e["bytes"] += nbytes

    def add_collective(self, coords: tuple, kind: str, nbytes: int) -> None:
        if kind not in COLLECTIVE_KINDS:
            raise ValueError(f"unknown collective kind {kind!r}")
        for e in self._targets(coords):
            e["collective_bytes"][kind] = e["collective_bytes"].get(kind, 0) + nbytes
            e["collective_counts"][kind] = e["collective_counts"].get(kind, 0) + 1

    def replay(self, coords: tuple, entry: dict) -> None:
        for e in self._targets(coords):
            _merge(e, entry)

    @contextlib.contextmanager
    def suspended(self):
        self._paused += 1
        try:
            yield
        finally:
            self._paused -= 1

    # -- the result --------------------------------------------------------
    def position_totals(self):
        """Yields (coordinates dict, total entry) for every position of the
        mesh: the entries whose coordinates agree with it, summed."""
        names = self.mesh.axis_names
        for key in self.entries:
            unknown = [a for a, _ in key if a not in names]
            if unknown:
                raise ValueError(f"work counted on axes {unknown} outside the mesh {names}")
        keyed = [(dict(k), e) for k, e in self.entries.items()]
        for idx in itertools.product(*(range(s) for s in self.mesh.devices.shape)):
            here = dict(zip(names, idx))
            total = _entry()
            for coords, e in keyed:
                if all(here[a] == i for a, i in coords.items()):
                    _merge(total, e)
            yield here, total

    def analysis(self) -> dict:
        """The largest per-position total of each metric over the mesh, with
        the keys of ``hlo_analysis.analyze``."""
        best = {"flops": 0, "bytes": 0, "collective_total": 0}
        coll = {k: 0 for k in COLLECTIVE_KINDS}
        counts = {k: 0 for k in COLLECTIVE_KINDS}
        for _here, t in self.position_totals():
            best["flops"] = max(best["flops"], t["flops"])
            best["bytes"] = max(best["bytes"], t["bytes"])
            best["collective_total"] = max(best["collective_total"],
                                           sum(t["collective_bytes"].values()))
            for k in COLLECTIVE_KINDS:
                coll[k] = max(coll[k], t["collective_bytes"].get(k, 0))
                counts[k] = max(counts[k], t["collective_counts"].get(k, 0))
        return {"flops": best["flops"], "bytes": best["bytes"], "collective_bytes": coll,
                "collective_counts": counts, "collective_total": best["collective_total"],
                "positions": self.mesh.size, "ops": self.ops,
                "represented_positions": self.represented,
                "represented_steps": self.represented_steps}
