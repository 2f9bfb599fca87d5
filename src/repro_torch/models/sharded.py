"""Tensor parallelism over 'model' for the dense decoder stack, the moe
family (expert parallelism over the same axis), RWKV6, the hybrid Mamba
stack and whisper's encoder-decoder, and context-parallel decode of a
one-row batch (TaCo retrieval attention among it): the port's
counterpart of what GSPMD makes of ``repro.models.model``'s ``forward``,
``prefill`` and ``decode_step`` under ``repro.launch.sharding``'s specs
(:mod:`repro_torch.launch.sharding`).

A parameter tree is placed (:func:`place`) as a tree of :class:`Placed`:
each leaf split by its spec into per-position blocks, each block its own
leaf tensor on its position's device, so that autograd gives each block its
own gradient; blocks that only replicated axes tell apart are one block, so
on one card the blocks of a model are one copy of it. The execution keeps
the idiom of :mod:`repro_torch.mesh`: one process walks the positions in
order, a collective is a sum or a concatenation in position order
(:mod:`repro_torch.models.sharding_utils`), which reports its payload.

Per data block (``B / |dp|`` rows over the data axes) and per 'model'
position, as Megatron splits a layer:

  embedding   the table split over the vocabulary: a position looks up the
              ids in its range, zeros elsewhere; ``model_sum``.
  attention   ``wq``/``wk``/``wv`` column blocks, ``wo`` a row block; each
              position runs :func:`repro_torch.models.attention.self_attention`
              (the flash kernel on the card) on its heads; the out
              projection's partial sums through ``model_sum``. Where the
              heads do not divide |model| (the split falls inside a head),
              whole heads are gathered first (q, k, v; k and v alone where
              only the KV heads do not divide), each position runs
              ceil(H / |model|) heads (positions past H none), and the
              output is gathered again to be re-split into ``wo``'s rows.
  MLP         gate/up/fc column blocks, down/proj row blocks, ``model_sum``.
  head        ``lm_head`` split over its columns: the logits stay split
              (the train loss is a vocab-parallel cross entropy);
              prefill and decode gather one position's logits only.
  norms       replicated: the residual stream is computed once a data
              block, outside the positions, as every position holds it.
  MoE         the router replicated: each data block's routing (the f32
              softmax, top-k, slot-major capacity ``max(1, int(T k cf / E))``
              of its T tokens: a block is one dispatch chunk) computed once,
              outside the positions. Where the experts divide |model| (the
              sanitized specs split gate/up/down over their expert axis),
              each position dispatches to its E / |model| experts and the
              partial outputs (each token's share of its k entries, summed
              in float32) go through ``model_sum``; where they do not
              (granite-moe's 40 over 16: gate/up split over the expert FFN
              width, down over its output columns), the (E, cap, D) buffer
              is built once, each position computes its columns of
              silu(gate) * up, those are gathered (``model_gather``), each
              position computes its columns of the down product and combines
              them by the gates, and the (T, D) output is gathered. A
              dense residual MLP (arctic's) is the Megatron MLP above.
  RWKV6       the time mix over whole heads: the token-shift mixes and the
              decay LoRA's first product replicated, wr/wk/wv/wg column
              blocks, each position's columns of the decay from its slice
              of the replicated w0 and w_lora_b (whose gradients are then
              all-gathered: ``replicated_slice``), the WKV over its heads
              (u a row block), ln_x's RMS over the whole d_model from the
              positions' float32 sums of squares (``model_sum``), wo row
              blocks. The channel mix: wk columns, wv rows, r's column
              blocks gathered.
  encoder     whisper's: the frames plus the learned positions and the
              final norm once a data block (replicated, as the residual
              stream), each layer's non-causal self-attention and MLP
              split as the decoder's; its output replicated over the
              positions (``model_copy``: its gradient is the positions'
              sum).
  cross-attn  ``wq`` column blocks of the decoder's h, ``wk``/``wv`` column
              blocks of the encoder's output, each position's heads through
              :func:`repro_torch.models.attention.cross_attention` (the
              flash kernel, non-causal), ``wo`` row blocks.
  Mamba       in_proj's contiguous column blocks re-split to each
              position's x and z channels (an all-to-all), the causal conv
              and the selective scan over the position's inner channels,
              x_proj's and out_proj's row-block products in float32 summed
              through ``model_sum`` (every position then has the whole
              dt_low, B and C), dt_proj column blocks.

A row-parallel partial sum is added in float32 and cast once. Prefill
writes its cache in :func:`repro_torch.launch.sharding.cache_pspecs`'
layout, K/V split over 'model' along the sequence (an all-to-all from the
head split); decode gathers q over 'model', each position attends over its
block of the sequence for all heads, and the partial softmax sums are
merged by log-sum-exp (``lse_combine``) before ``wo``'s row blocks.

The MoE's load-balance aux loss is formed from each block's routing
statistics (:func:`moe_aux`): ``moe_impl="gspmd"`` takes E sum_e f_e p_e
over the whole batch (the blocks' token counts and probability sums added
over the data axes first), ``"manual"`` the mean over the blocks of each
block's product, as the reference's two MoE paths do; the train step adds
it once for the batch.

Prefill also writes the recurrent states in ``cache_pspecs``' layout: the
WKV state over the heads, Mamba's conv window and h over the inner
channels, the token shifts replicated; decode reads and updates them in
place.

Prefill writes whisper's cross cache as the sanitized specs place it:
along the encoder's frames where |model| divides them, else along head_dim
(an all-to-all from the head split either way). Decode reads it as placed:
along the frames, each position's partial softmax sums over its frames
merged by ``lse_combine``; along head_dim, each position's q·kᵀ over its
slice for every head, summed in float32 (``model_sum``) into the whole
scores, the softmax once, each position's slice of probs·v gathered.

Context parallelism: a decode step's one-row batch that the data positions
cannot split (long_500k's B = 1) runs as one block served by every
position, its K/V sequence split over the data axes and 'model' (the first
axis the major one); the projections run once over 'model' for all data
positions, and the attention over each position's block of the sequence,
the partial softmax sums merged over all of them. A TaCo layer
(:func:`_taco_attention`) gathers the state's mean, basis and centroids
whole, updates the replicated cells, selects the slots once over the whole
sequence (:func:`repro_torch.models.taco_attention.select_slots`), and each
position attends over the selected slots in its block.

The dense stack (attention mixers and dense MLPs, RoPE or none, an
optional vlm patch prefix), the moe family's attention stack, RWKV6 (the
channel mix as its FFN), the hybrid stack (Mamba and attention mixers,
dense or MoE FFNs) and whisper's encoder-decoder run here with full
attention, and with TaCo attention in a decode step; anything else raises
``NotImplementedError`` (:func:`check_supported`).
"""
from __future__ import annotations

import dataclasses
import functools
import itertools

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint, set_checkpoint_early_stop

from repro_torch.launch.sharding import (
    cache_pspecs,
    param_pspecs,
    sanitize_specs,
    train_state_pspecs,
)
from repro_torch.mesh import (
    P,
    DeviceMesh,
    axis_size,
    block,
    block_slices,
    entry_axes,
    local_shape,
    one_pass,
    recompute_context,
    tally,
    tensor_bytes,
    walk,
)
from repro_torch.models import attention as A
from repro_torch.models import moe as MOE
from repro_torch.models import ssm as S
from repro_torch.models import taco_attention as TA
from repro_torch.models.layers import apply_norm, apply_rope, dense, gelu, rope_angles, silu
from repro_torch.models.model import _ENC_SPEC, ArchConfig, _frontend, init_cache, map_tree
from repro_torch.models.sharding_utils import (
    lse_combine,
    model_copy,
    model_gather,
    model_max,
    model_all_to_all,
    model_sum,
    replicated_slice,
)
from repro_torch.train.losses import IGNORE
from repro_torch.utils import tree_flatten, tree_map

MODEL = "model"


# ============================================================ placement ===
class Placed:
    """One tensor of ``shape`` split by ``spec`` over ``mesh``: ``blocks``
    maps the coordinates of ``axes`` (the mesh axes the spec names, in mesh
    order) to that block, on the device of the first position with them."""

    __slots__ = ("spec", "shape", "dtype", "mesh", "axes", "blocks")

    def __init__(self, spec, shape, dtype, mesh: DeviceMesh, blocks: dict):
        named = {a for e in spec for a in entry_axes(e)}
        self.spec, self.shape, self.dtype, self.mesh = P(*spec), tuple(shape), dtype, mesh
        self.axes = tuple(a for a in mesh.axis_names if a in named)
        self.blocks = blocks

    def keys(self) -> list:
        """The blocks' coordinates in position order (row-major over the
        mesh's axes)."""
        return list(itertools.product(*(range(self.mesh.shape[a]) for a in self.axes)))

    def coords(self, key) -> dict:
        return dict(zip(self.axes, key))

    def key(self, coords: dict) -> tuple:
        return tuple(coords[a] for a in self.axes)

    def at(self, coords: dict) -> torch.Tensor:
        """The block of the position at ``coords`` (it names at least the
        spec's axes)."""
        return self.blocks[self.key(coords)]

    def __repr__(self):
        return f"Placed({self.spec}, {self.shape}, {self.dtype}, {len(self.blocks)} blocks)"


def _device(mesh: DeviceMesh, coords: dict) -> torch.device:
    return mesh.devices[tuple(coords.get(a, 0) for a in mesh.axis_names)]


def _full(spec, ndim: int) -> P:
    return P(*(tuple(spec) + (None,) * (ndim - len(spec))))


def place_leaf(t: torch.Tensor, spec, mesh: DeviceMesh) -> Placed:
    """``t`` split by ``spec``: each block a new contiguous tensor on its
    position's device (a ``meta`` tensor stays meta)."""
    spec = _full(spec, t.dim())
    out = Placed(spec, t.shape, t.dtype, mesh, {})
    for key in out.keys():
        coords = out.coords(key)
        dev = t.device if t.is_meta else _device(mesh, coords)
        part = block(t.detach(), spec, mesh, coords)
        out.blocks[key] = torch.empty(part.shape, dtype=t.dtype, device=dev).copy_(part)
    return out


def place(tree, specs, mesh: DeviceMesh):
    """A tree of tensors as a tree of :class:`Placed` (``specs`` a tree of
    :class:`~repro_torch.mesh.P` of the same structure)."""
    return tree_map(lambda t, s: place_leaf(t, s, mesh), tree, specs)


def placed_zeros(shape, dtype, spec, mesh: DeviceMesh, device=None) -> Placed:
    """A zero tensor of ``shape`` placed by ``spec``, made block by block
    (``device`` overrides the positions' devices: ``meta``)."""
    spec = _full(spec, len(shape))
    out = Placed(spec, shape, dtype, mesh, {})
    local = local_shape(shape, spec, mesh)
    for key in out.keys():
        dev = device if device is not None else _device(mesh, out.coords(key))
        out.blocks[key] = torch.zeros(local, dtype=dtype, device=dev)
    return out


def unplace(tree):
    """The whole tensors of a tree of :class:`Placed` (on each leaf's first
    block's device)."""
    def whole(pl: Placed) -> torch.Tensor:
        first = next(iter(pl.blocks.values()))
        out = torch.empty(pl.shape, dtype=pl.dtype, device=first.device)
        for key, b in pl.blocks.items():
            out[block_slices(pl.shape, pl.spec, pl.mesh, pl.coords(key))] = b.detach().to(
                out.device)
        return out

    return tree_map(whole, tree)


def place_train_state(state, mesh: DeviceMesh, data_axes=("data",)):
    """A :class:`~repro_torch.train.loop.TrainState` of whole tensors placed
    by :func:`~repro_torch.launch.sharding.train_state_pspecs`, sanitized
    (the parameters over 'model', AdamW's moments also over ``data_axes``:
    ZeRO-1); the step counters stay on the host."""
    specs = sanitize_specs(state, train_state_pspecs(state, tuple(data_axes), mesh), mesh)
    opt = dataclasses.replace(
        state.opt_state,
        **{f.name: place(getattr(state.opt_state, f.name),
                         getattr(specs.opt_state, f.name), mesh)
           for f in dataclasses.fields(state.opt_state) if f.name != "step"})
    return dataclasses.replace(state, params=place(state.params, specs.params, mesh),
                               opt_state=opt)


def unplace_train_state(state):
    """The whole tensors of a placed train state."""
    opt = dataclasses.replace(
        state.opt_state, **{f.name: unplace(getattr(state.opt_state, f.name))
                            for f in dataclasses.fields(state.opt_state) if f.name != "step"})
    return dataclasses.replace(state, params=unplace(state.params), opt_state=opt)


def param_specs(params, mesh: DeviceMesh):
    """The sanitized parameter specs of a tree of tensors."""
    return sanitize_specs(params, param_pspecs(params), mesh)


def cache_specs(cache, mesh: DeviceMesh, data_axes):
    return sanitize_specs(cache, cache_pspecs(cache, tuple(data_axes)), mesh)


# ======================================================= the positions ===
def check_supported(cfg: ArchConfig, *, decode: bool = False) -> None:
    """Raise NotImplementedError unless ``cfg`` is a stack this module
    splits: attention, RWKV6 or hybrid (Mamba and attention) mixers with
    dense MLPs, the channel mix or the MoE, or whisper's encoder-decoder
    (an attention stack with an audio frontend); full attention, or TaCo
    retrieval attention for a decode step (``decode``) of a decoder-only
    stack."""
    moe_ok = not cfg.n_experts or cfg.family in ("moe", "hybrid")
    enc_dec = bool(cfg.encoder_layers)
    met = []
    if cfg.mixer not in ("attn", "rwkv", "hybrid") or not moe_ok:
        met.append(f"mixer {cfg.mixer!r} with {cfg.n_experts} experts in family {cfg.family!r}")
    if enc_dec and (cfg.frontend != "audio" or cfg.mixer != "attn" or cfg.n_experts):
        met.append(f"an encoder with frontend {cfg.frontend!r}")
    if cfg.frontend not in (None, "vlm") and not (enc_dec and cfg.frontend == "audio"):
        met.append(f"frontend {cfg.frontend!r} without an encoder")
    if cfg.attention_kind == "taco" and (not decode or enc_dec):
        met.append("TaCo attention " + ("with an encoder" if enc_dec else
                                        "outside a decode step (its prefill runs on one device)"))
    elif cfg.attention_kind not in ("full", "taco"):
        met.append(f"attention_kind {cfg.attention_kind!r}")
    if met:
        raise NotImplementedError(
            f"{cfg.name}: {'; '.join(met)}: tensor parallelism covers the dense stack, the "
            "moe family's experts, RWKV6, the hybrid Mamba stack and whisper's "
            "encoder-decoder with full attention, and TaCo attention in a decode step")


@dataclasses.dataclass(frozen=True)
class HeadPlan:
    """Which heads each of ``n`` 'model' positions runs. ``q_local``: the
    query heads divide, so a position's column block of ``wq`` is whole
    heads; ``kv_local``: so do the KV heads, and a position's KV block is
    the one its query heads read."""

    n: int
    heads: int
    kv: int

    @property
    def group(self) -> int:
        return self.heads // self.kv

    @property
    def q_local(self) -> bool:
        return self.heads % self.n == 0

    @property
    def kv_local(self) -> bool:
        return self.q_local and self.kv % self.n == 0

    def q_range(self, m: int) -> tuple[int, int]:
        per = -(-self.heads // self.n)
        return min(m * per, self.heads), min((m + 1) * per, self.heads)

    def describe(self) -> str:
        if self.kv_local:
            return "heads split"
        if self.q_local:
            return "query heads split, K/V gathered"
        return f"q, k, v gathered, {-(-self.heads // self.n)} heads a position"


def _kv_heads(k, h0: int, h1: int, g: int):
    """The KV heads query heads [h0, h1) read, as a (B, S, kv, hd) tensor
    those heads share by GQA's grouping: whole groups, one group, or each
    query head's own copy."""
    if h0 % g == 0 and (h1 - h0) % g == 0:
        return k[:, :, h0 // g:h1 // g]
    if h0 // g == (h1 - 1) // g:
        return k[:, :, h0 // g:h0 // g + 1]
    return k.repeat_interleave(g, dim=2)[:, :, h0:h1]


class _Row:
    """One data block's walk over the 'model' positions: its data
    coordinates ``row``."""

    def __init__(self, cfg: ArchConfig, mesh: DeviceMesh, row: dict, impl: str):
        self.cfg, self.mesh, self.row, self.impl = cfg, mesh, row, impl
        self.n = axis_size(mesh, MODEL)
        self.plan = HeadPlan(self.n, cfg.n_heads, cfg.n_kv_heads)
        self.home = _device(mesh, self.at(0))

    def at(self, m: int) -> dict:
        return {**self.row, MODEL: m}

    def dev(self, m: int) -> torch.device:
        return _device(self.mesh, self.at(m))

    def walk(self, fn, enter, params=(), even: bool = True) -> list:
        """``fn(m, *enter(m))`` at each position; ``params(m)`` are the
        position's blocks it reads, for the counter's representative
        (``even``: the positions' work differs in nothing but their
        blocks)."""
        inputs = ((lambda m: [t for t in (*enter(m), *params(m)) if t is not None])
                  if even else None)
        return walk(self.n, self.at, fn, inputs, enter=enter)

    def local(self, tree, m: int):
        """A subtree of :class:`Placed` as position m's tensors."""
        return map_tree(lambda pl: pl.at(self.at(m)), tree)


def _kind(pl: Placed) -> str:
    """'column', 'row' or 'whole': how a (group view of a) weight or bias is
    split over 'model' (nothing else is)."""
    spec = tuple(pl.spec)
    split = [i for i, e in enumerate(spec) if MODEL in entry_axes(e)]
    if any(e is not None and MODEL not in entry_axes(e) for e in spec) or len(split) > 1:
        raise NotImplementedError(f"a parameter split {pl.spec} is not a Megatron split")
    if not split:
        return "whole"
    return "column" if split[0] == len(spec) - 1 else "row"


def _check(r: _Row, p: dict, want: str, name: str) -> None:
    """Raise NotImplementedError unless projection ``p`` is split as ``want``
    ('column': weight and bias over their last dimension; 'row': the weight
    over its first, the bias whole). With one 'model' position a whole
    weight or bias is its block; with more, each position would compute the
    whole product and the sums would count it |model| times."""
    bias = "column" if want == "column" else "whole"
    kinds = [(_kind(p["w"]), want)] + ([(_kind(p["b"]), bias)] if "b" in p else [])
    if any(got != need and not (got == "whole" and r.n == 1) for got, need in kinds):
        raise NotImplementedError(f"{name}: a {kinds[0][0]} split where tensor parallelism "
                                  f"over {r.n} 'model' positions needs {want} blocks")


def _bias(p: dict, dtype):
    """A row-parallel projection's bias (replicated), added once after the
    sum."""
    return p["b"].at({}).to(dtype) if "b" in p else None


def _row_sum(parts, bias, dtype):
    y = model_sum(parts, dtype=dtype)
    return y if bias is None else y + bias.to(y.device)


def _groups(tree, n: int) -> list:
    """The ``n`` groups of a tree of stacked :class:`Placed`: entry g of
    each block, a view of the stacked block or, where a train step reads
    its parameters as one leaf a group
    (:func:`repro_torch.train.loop.make_sharded_train_step`), that group's
    leaf."""
    leaves, rebuild = tree_flatten(tree)
    return [rebuild([Placed(P(*pl.spec[1:]), pl.shape[1:], pl.dtype, pl.mesh,
                            {k: b[g] for k, b in pl.blocks.items()}) for pl in leaves])
            for g in range(n)]


# ---------------------------------------------------------- embedding ---
def _embed(r: _Row, table: Placed, ids):
    if _kind(table) == "whole":
        return table.at({})[ids.to(table.at({}).device)]
    if _kind(table) != "row":
        raise NotImplementedError(f"an embedding split {table.spec}")

    def part(m):
        t = table.at(r.at(m))
        local = ids.to(t.device) - m * t.shape[0]
        inside = (local >= 0) & (local < t.shape[0])
        rows = t[local.clamp(0, t.shape[0] - 1)]
        return torch.where(inside[..., None], rows, torch.zeros((), dtype=rows.dtype,
                                                                device=rows.device))

    parts = r.walk(lambda m: part(m), lambda m: (), lambda m: [ids, table.at(r.at(m))])
    return model_sum(parts, dtype=table.dtype)


# ---------------------------------------------------------- attention ---
def _qkv_columns(r: _Row, p: dict, h, hkv=None):
    """Each position's column products (q of the normed h, k and v of
    ``hkv``: h itself, or the encoder's output for cross-attention)."""
    for name in ("wq", "wk", "wv"):
        _check(r, p[name], "column", name)
    leaves = [p[n][k] for n in ("wq", "wk", "wv") for k in ("w", "b") if k in p[n]]

    def cols(m, hm, km=None):
        lp = r.local({n: p[n] for n in ("wq", "wk", "wv")}, m)
        dev = r.dev(m)
        km = hm if km is None else km
        return (dense(lp["wq"], hm.to(dev)), dense(lp["wk"], km.to(dev)),
                dense(lp["wv"], km.to(dev)))

    ins = (model_copy(h),) if hkv is None else (model_copy(h), model_copy(hkv))
    return r.walk(cols, lambda m: ins, lambda m: [pl.at(r.at(m)) for pl in leaves])


def _heads(r: _Row, cols, rope, b: int, s: int, t: int):
    """The heads gathered over 'model' where a position's column blocks are
    not whole heads: (q (B, S, H, hd), k, v (B, T, Kv, hd)), q and k with
    RoPE, each None where the positions' own blocks serve
    (:class:`HeadPlan`)."""
    cfg, plan = r.cfg, r.plan
    hd = cfg.hd
    qf = kf = vf = None
    if not plan.q_local:
        qf = model_gather([c[0] for c in cols], -1).reshape(b, s, cfg.n_heads, hd)
        if rope is not None:
            qf = apply_rope(qf, *rope)
    if not plan.kv_local:
        kf = model_gather([c[1] for c in cols], -1).reshape(b, t, cfg.n_kv_heads, hd)
        vf = model_gather([c[2] for c in cols], -1).reshape(b, t, cfg.n_kv_heads, hd)
        if rope is not None:
            kf = apply_rope(kf, *rope)
    return qf, kf, vf


def _core(r: _Row, m: int, cols, qf, kf, vf, rope, b: int, s: int, t: int, q_chunk: int,
          kind: str):
    """Position m's attention core over its query heads (``kind``: 'causal'
    or 'full' self-attention of S = T tokens, or 'cross' over T others):
    (out (B, S, n·hd), its RoPE'd k and its v where the KV heads are its
    own)."""
    cfg, plan = r.cfg, r.plan
    hd, g = cfg.hd, plan.group
    h0, h1 = plan.q_range(m)
    k_own = v_own = None
    if plan.q_local:
        q = cols[0].reshape(b, s, h1 - h0, hd)
        if rope is not None:
            q = apply_rope(q, *rope)
    else:
        q = qf[:, :, h0:h1]
    if plan.kv_local:
        k_own = cols[1].reshape(b, t, cfg.n_kv_heads // r.n, hd)
        v_own = cols[2].reshape(b, t, cfg.n_kv_heads // r.n, hd)
        if rope is not None:
            k_own = apply_rope(k_own, *rope)
        k, v = k_own, v_own
    elif h1 > h0:
        k, v = _kv_heads(kf, h0, h1, g), _kv_heads(vf, h0, h1, g)
    if h1 <= h0:
        return q.reshape(b, s, 0), k_own, v_own
    if kind == "cross":
        out = A.cross_attention(q, k, v, impl=r.impl)
    else:
        out = A.self_attention(q, k, v, causal=kind == "causal", q_chunk=q_chunk, impl=r.impl)
    return out.reshape(b, s, (h1 - h0) * hd), k_own, v_own


def _attention(r: _Row, p: dict, h, rope, cache=None, *, causal: bool = True, xkv=None):
    """Self-attention of one data block's normed h (B, S, D) over 'model'
    (causal, or not: the encoder's), or with ``xkv`` (B, T, D), the
    encoder's output, cross-attention over it; with ``cache`` (this group's
    :class:`Placed` blocks of the row) the RoPE'd K/V are written in its
    sequence split (cross-attention's into ``cross_k``/``cross_v`` in
    their split, :func:`_write_cross`). Returns the sub-layer's output
    (B, S, D)."""
    cfg, plan = r.cfg, r.plan
    b, s = h.shape[:2]
    t = s if xkv is None else xkv.shape[1]
    kind = "cross" if xkv is not None else "causal" if causal else "full"
    _check(r, p["wo"], "row", "wo")
    qc = cfg.attn_q_chunk or (2048 if s >= 8192 else 0)
    qc = qc if s > qc else 0
    cols = _qkv_columns(r, p, h, xkv)
    qf, kf, vf = _heads(r, cols, rope, b, s, t)
    wo = p["wo"]

    def core(m, q_m, k_m, v_m, qf_m, kf_m, vf_m):
        out, k_own, v_own = _core(r, m, (q_m, k_m, v_m), qf_m, kf_m, vf_m, rope, b, s, t, qc,
                                  kind)
        if not plan.q_local:
            return out, k_own, v_own
        return dense({"w": wo["w"].at(r.at(m))}, out), k_own, v_own

    even = plan.q_local
    outs = r.walk(core, lambda m: (*cols[m], qf, kf, vf), lambda m: [wo["w"].at(r.at(m))],
                  even=even)
    if plan.q_local:
        partials = [o[0] for o in outs]
    else:
        full = model_gather([o[0] for o in outs], -1)
        rows = full.shape[-1] // r.n

        def proj(m, f):
            return dense({"w": wo["w"].at(r.at(m))}, f[..., m * rows:(m + 1) * rows])

        partials = r.walk(proj, lambda m: (full,), lambda m: [wo["w"].at(r.at(m))])
    y = _row_sum(partials, _bias(wo, h.dtype), h.dtype)
    if cache is not None:
        if plan.kv_local:
            # an all-to-all to the sequence split, each position sending a
            # sequence block of its heads to each other
            kf = model_all_to_all([o[1] for o in outs], 2)
            vf = model_all_to_all([o[2] for o in outs], 2)
        (_write_prompt if xkv is None else _write_cross)(r, cache, kf, vf)
    return y


def _write_prompt(r: _Row, cache: dict, k, v):
    """Write the prompt's k, v (B, T, kv, hd) at sequence positions [0, T)
    of the row's cache blocks, each position its block of the sequence."""
    size = cache["k"].at(r.at(0)).shape[1]

    def window(m):
        return m * size, min(k.shape[1], (m + 1) * size)

    def write(m):
        a, z = window(m)
        for name, src in (("k", k), ("v", v)):
            dst = cache[name].at(r.at(m))
            if z > a:
                dst[:, :z - a] = src[:, a:z].to(dst.device, dst.dtype)

    even = len({max(0, z - a) for a, z in map(window, range(r.n))}) == 1
    r.walk(lambda m: write(m), lambda m: (), lambda m: [cache["k"].at(r.at(m))], even=even)


def _cross_dim(pl: Placed) -> int | None:
    """Which dimension of a cross cache leaf (a row's group view, (B, T, kv,
    hd)) is split over 'model': 1 (the encoder's frames) or 3 (head_dim,
    where the sanitized specs moved the split because |model| does not
    divide T), None where it is whole; any other split raises
    NotImplementedError."""
    split = [i for i, e in enumerate(pl.spec) if MODEL in entry_axes(e)]
    if any(e is not None and MODEL not in entry_axes(e) for e in pl.spec) or split not in (
            [], [1], [3]):
        raise NotImplementedError(f"a cross cache split {pl.spec}: the port reads one split "
                                  "along the frames or along head_dim")
    return split[0] if split else None


def _write_cross(r: _Row, cache: dict, k, v):
    """Write the encoder's k, v (B, T, kv, hd) whole into the row's cross
    cache, each position its block along the frames or along head_dim."""
    for name in ("cross_k", "cross_v"):
        _cross_dim(cache[name])

    def write(m):
        for name, src in (("cross_k", k), ("cross_v", v)):
            pl = cache[name]
            dst = pl.at(r.at(m))
            dst.copy_(block(src, pl.spec, pl.mesh, {MODEL: m}).to(dst.device, dst.dtype))

    r.walk(lambda m: write(m), lambda m: (), lambda m: [cache["cross_k"].at(r.at(m))])


# ---------------------------------------------------------------- MLP ---
def _mlp(r: _Row, p: dict, h):
    if "gate" in p:
        ins, out = ("gate", "up"), "down"
    else:
        ins, out = ("fc",), "proj"
    for name in ins:
        _check(r, p[name], "column", name)
    _check(r, p[out], "row", out)
    leaves = [p[n][k] for n in (*ins, out) for k in ("w", "b") if k in p[n]
              and not (n == out and k == "b")]

    def part(m, hm):
        lp = r.local({n: p[n] for n in ins}, m)
        hm = hm.to(r.dev(m))
        if "gate" in lp:
            z = silu(dense(lp["gate"], hm)) * dense(lp["up"], hm)
        else:
            z = gelu(dense(lp["fc"], hm))
        return dense({"w": p[out]["w"].at(r.at(m))}, z)

    hc = model_copy(h)
    parts = r.walk(part, lambda m: (hc,), lambda m: [pl.at(r.at(m)) for pl in leaves])
    return _row_sum(parts, _bias(p[out], h.dtype), h.dtype)


# ---------------------------------------------------------------- MoE ---
def _expert_split(r: _Row, p: dict) -> str:
    """'experts' (gate/up/down split over their expert axis, or whole over
    one position) or 'width' (gate/up over the expert FFN width, down over
    its output columns), read from the placed leaves; any other split
    raises NotImplementedError."""
    def dim(name):
        split = [i for i, e in enumerate(p[name].spec) if MODEL in entry_axes(e)]
        if any(e is not None and MODEL not in entry_axes(e) for e in p[name].spec) or len(
                split) > 1:
            raise NotImplementedError(f"moe {name}: a split {p[name].spec}")
        return split[0] if split else None

    dims = (dim("gate"), dim("up"), dim("down"))
    if _kind(p["router"]) != "whole":
        raise NotImplementedError(f"moe router: a split {p['router'].spec}")
    if dims == (0, 0, 0) or (dims == (None,) * 3 and r.n == 1):
        return "experts"
    if dims == (2, 2, 2):
        return "width"
    raise NotImplementedError(f"moe: gate/up/down split along {dims} over {r.n} 'model' "
                              "positions (the experts or the expert FFN width are)")


def _moe(r: _Row, p: dict, h):
    """The routed MoE of one data block's normed h (B, S, D) over 'model'
    (one dispatch chunk): (y (B, S, D), its routing statistics (2, E)
    float32: the first choices' token counts and the router probabilities'
    sums over the block's tokens, the second carrying the router's
    gradient)."""
    cfg = r.cfg
    b, s, d = h.shape
    t, e, k = b * s, cfg.n_experts, cfg.experts_per_token
    cap = max(1, int(t * k * cfg.capacity_factor / e))
    split = _expert_split(r, p)
    x2 = h.reshape(t, d)
    probs = MOE._router_probs(p["router"].at({}).to(x2.device), x2)
    exp_idx, gate_vals, fe, pos, keep = MOE.route(probs, k, cap)
    gates = gate_vals.T.reshape(-1)
    hot = (exp_idx[:, 0, None] == torch.arange(e, device=x2.device)).to(torch.float32)
    stats = torch.stack([hot.sum(0), probs.sum(0)])
    weights = ("gate", "up", "down")
    gatesc = model_copy(gates)
    if split == "experts":
        e_loc = e // r.n
        x2c = model_copy(x2)

        def part(m, xm, gm):
            dev = r.dev(m)
            le = fe.to(dev) - m * e_loc
            kept = keep.to(dev) & (le >= 0) & (le < e_loc)
            row = torch.where(kept, le * cap + pos.to(dev), e_loc * cap)
            # the position's share of each token's sum over its k entries,
            # in float32: the sum over positions rounds once, as one sum does
            return MOE._dispatch(xm.to(dev), row, kept, gm.to(dev), cap,
                                 [p[n].at(r.at(m)) for n in weights], torch.float32)

        parts = r.walk(part, lambda m: (x2c, gatesc),
                       lambda m: [p[n].at(r.at(m)) for n in weights])
        return model_sum(parts, dtype=h.dtype).reshape(b, s, d), stats

    # the expert FFN width: the buffer once, h's column blocks gathered, the
    # down product's output columns combined by the gates, then gathered
    rows = e * cap
    row = torch.where(keep, fe * cap + pos, rows)
    buf = x2.new_zeros((rows + 1, d))
    buf[row] = x2.repeat(k, 1)
    bufc = model_copy(buf[:-1].view(e, cap, d))

    def cols(m, bm):
        bm = bm.to(r.dev(m))
        gate, up = p["gate"].at(r.at(m)), p["up"].at(r.at(m))
        return silu(torch.bmm(bm, gate.to(bm.dtype))) * torch.bmm(bm, up.to(bm.dtype))

    hidden = model_gather(r.walk(cols, lambda m: (bufc,),
                                 lambda m: [p[n].at(r.at(m)) for n in ("gate", "up")]), -1)
    at = torch.where(keep, row, 0)

    def out(m, hm, gm):
        dev = r.dev(m)
        down = p["down"].at(r.at(m))
        y = torch.bmm(hm.to(dev), down.to(hm.dtype)).reshape(rows, -1)[at.to(dev)]
        y = torch.where(keep.to(dev)[:, None], y * gm.to(dev)[:, None].to(y.dtype), 0)
        return y.reshape(k, t, -1).sum(dim=0)

    outs = r.walk(out, lambda m: (hidden, gatesc), lambda m: [p["down"].at(r.at(m))])
    return model_gather(outs, -1).reshape(b, s, d), stats


def blockwise_aux(cfg: ArchConfig) -> bool:
    """Whether a data block's share of the aux loss (and of its gradient)
    depends on its own routing alone: no MoE, or ``moe_impl="manual"``."""
    return not cfg.n_experts or cfg.moe_impl == "manual"


def moe_aux(cfg: ArchConfig, stats: list, tokens: int, n_blocks: int | None = None):
    """The MoE layers' load-balance aux loss, summed over the layers, from
    the data blocks' routing statistics (each (L, 2, E), a block of
    ``tokens`` tokens): (aux, one term a block whose gradient is aux's
    through that block's statistics).

    ``moe_impl="gspmd"``: E sum_e f_e p_e over the whole batch, the
    blocks' statistics first added over the data axes (a small all-reduce
    in position order); ``stats`` must hold every block. aux carries no
    gradient; block d's term, E sum_e f_e p_{d,e} / T with the batch's
    f_e held fixed, does (the first-choice counts have none).
    ``"manual"``: each block's product, averaged over the ``n_blocks``
    blocks (default ``len(stats)``): a term is its block's product over
    ``n_blocks``, and aux is the terms' sum."""
    e = cfg.n_experts
    if cfg.moe_impl == "manual":
        n_blocks = n_blocks or len(stats)
        terms = [e * torch.sum((st[:, 0] / tokens) * (st[:, 1] / tokens)) / n_blocks
                 for st in stats]
        aux = terms[0].detach()
        for term in terms[1:]:
            aux = aux + term.detach().to(aux.device)
        return aux, terms
    n = tokens * len(stats)
    # an all-reduce over the data axes, model_sum's float32 sum in position order
    summed = model_sum([st.detach() for st in stats])
    frac_tokens = summed[:, 0] / n
    aux = e * torch.sum(frac_tokens * (summed[:, 1] / n))
    terms = [e * torch.sum(frac_tokens.to(st.device) * st[:, 1]) / n for st in stats]
    return aux, terms


def _ffn(r: _Row, spec: dict, p: dict, h, prev=None):
    """The sub-layer's FFN over h: (y, the MoE's routing statistics or
    None). The channel mix reads ``prev``, h one token earlier (the
    sequence shifted, or the cached token in decode)."""
    if spec["ffn"] == "mlp":
        return _mlp(r, p["ffn"], h), None
    if spec["ffn"] == "channel_mix":
        return _channel_mix(r, p["ffn"], h, S._shift(h) if prev is None else prev), None
    if spec["ffn"] not in ("moe", "moe_dense"):
        raise NotImplementedError(f"a {spec['ffn']} FFN")
    y, stats = _moe(r, p["moe"], h)
    if spec["ffn"] == "moe_dense":
        y = y + _mlp(r, p["ffn"], h)
    return y, stats


# --------------------------------------------------------------- RWKV6 ---
def _whole(p: dict, names, what: str) -> dict:
    """The replicated leaves ``names`` of ``p`` as tensors (their one block);
    NotImplementedError where one is split."""
    out = {}
    for name in names:
        for pl in tree_flatten(p[name])[0]:
            if _kind(pl) != "whole":
                raise NotImplementedError(f"{what} {name}: a split {pl.spec} where the layer "
                                          "reads it replicated")
        out[name] = map_tree(lambda pl: pl.at({}), p[name])
    return out


def _rwkv_split(r: _Row, p: dict) -> None:
    """Raise NotImplementedError unless the time mix is split over whole
    heads: wr/wk/wv/wg column blocks, wo row blocks, u over its heads (the
    sanitized specs move u onto head_dim where the heads do not divide
    |model|, and a split inside a head is not ported)."""
    for name in ("wr", "wk", "wv", "wg"):
        _check(r, p[name], "column", name)
    _check(r, p["wo"], "row", "wo")
    if r.n > 1 and _kind(p["u"]) != "row":
        heads = r.cfg.d_model // r.cfg.rwkv_head_dim
        raise NotImplementedError(
            f"rwkv: u split {p['u'].spec}: {heads} heads over {r.n} 'model' positions split "
            "inside a head; the time mix splits whole heads only")


def _rwkv(r: _Row, p: dict, h, cache=None, step: bool = False):
    """RWKV6's time mix of one data block's normed h (B, S, D) over 'model'
    (``step``: one token, S = 1, from the cached state). The token-shift
    mixes and the decay LoRA's first product (replicated) once, outside
    the positions; each position projects its column blocks of r, k, v, g,
    forms its columns of the decay w (its columns of w_lora_b and w0, no
    communication) and runs the WKV over its H / |model| heads (chunked
    where S divides by ``rwkv_chunk``, else sequential, as the reference
    picks). ln_x is an RMS norm over the whole d_model while y is split by
    heads: the positions' float32 sums of squares go through ``model_sum``
    before each scales its block. ``wo``'s row blocks' partial sums through
    ``model_sum``. With ``cache`` the x_prev (replicated) and each
    position's WKV state are written (prefill) or read and updated
    (step)."""
    cfg = r.cfg
    b, s, d = h.shape
    hd = cfg.rwkv_head_dim
    _rwkv_split(r, p)
    rep = _whole(p, ("mu", "w_lora_a"), "rwkv")
    x_prev = cache["x_prev"].at({})[:, None].to(h.dtype) if step else S._shift(h)
    mixes = [h + (x_prev.to(h.device) - h) * rep["mu"][i].to(h.dtype) for i in range(5)]
    lora = torch.tanh(mixes[3] @ rep["w_lora_a"].to(h.dtype))
    chunked = not step and bool(cfg.rwkv_chunk) and s % cfg.rwkv_chunk == 0
    names = ("wr", "wk", "wv", "wg")
    ins = [model_copy(t) for t in (mixes[0], mixes[1], mixes[2], mixes[4], lora)]
    w0, lora_b = _whole(p, ("w0", "w_lora_b"), "rwkv").values()
    if cache is not None and not step:
        cache["x_prev"].at({}).copy_(h[:, -1])

    def own(m):
        """Position m's blocks: the projections', u, and its columns of the
        replicated w0 and w_lora_b."""
        return ([p[n]["w"].at(r.at(m)) for n in names] + [p["u"].at(r.at(m))]
                + [replicated_slice(w0, -1, m, r.n), replicated_slice(lora_b, -1, m, r.n)])

    def heads(m, xr, xk, xv, xg, lo):
        dev = r.dev(m)
        *ws, u, w0_m, lb_m = own(m)
        rr, kk, vv, gg = (t.to(dev) @ w.to(h.dtype) for t, w in zip((xr, xk, xv, xg), ws))
        dd = lo.to(dev) @ lb_m.to(h.dtype)
        lw = -torch.exp(w0_m.to(torch.float32) + dd.to(torch.float32))
        if step:
            wkv = cache["wkv"].at(r.at(m))
            y, new = S._rwkv6_core(*(t.reshape(b, -1, hd).to(torch.float32)
                                     for t in (rr, kk, vv)),
                                   torch.exp(lw).reshape(b, -1, hd), u.to(torch.float32), wkv)
            wkv.copy_(new)
            y = y.reshape(b, 1, -1)
        elif chunked:
            y, new = S.wkv_chunked(rr, kk, vv, lw, u, hd, cfg.rwkv_chunk)
        else:
            y, new = S.wkv_sequential(rr, kk, vv, torch.exp(lw), u, hd)
        if cache is not None and not step:
            cache["wkv"].at(r.at(m)).copy_(new)
        y = y.to(h.dtype)
        yf = y.to(torch.float32)
        return y, gg, torch.sum(yf * yf, dim=-1, keepdim=True)

    outs = r.walk(heads, lambda m: ins, lambda m: own(m) + (
        [cache["wkv"].at(r.at(m))] if cache is not None else []))
    # ln_x's mean square over the whole d_model: an all-reduce of (B, S, 1)
    mean_sq = model_copy(model_sum([o[2] for o in outs]) / d)
    scale = _whole(p, ("ln_x",), "rwkv")["ln_x"]["scale"]
    wo = p["wo"]

    def out(m, y, g, ms):
        sc = replicated_slice(scale, -1, m, r.n)
        yn = (y.to(torch.float32) * torch.rsqrt(ms.to(y.device) + 1e-5)
              * sc.to(torch.float32)).to(y.dtype)
        return dense({"w": wo["w"].at(r.at(m))}, yn * silu(g))

    parts = r.walk(out, lambda m: (*outs[m][:2], mean_sq),
                   lambda m: [wo["w"].at(r.at(m)), replicated_slice(scale, -1, m, r.n)])
    if step:
        cache["x_prev"].at({}).copy_(h[:, 0])
    return _row_sum(parts, None, h.dtype)


def _channel_mix(r: _Row, p: dict, h, prev):
    """RWKV6's channel mix of h (B, S, D) over 'model', ``prev`` h one token
    earlier: the mixes (replicated) once; wk a column block, so relu^2 is
    local; wv a row block, its partial sums through ``model_sum``. wr
    (d_model -> d_model) is a column block too: its column blocks of r are
    gathered (``model_gather``, an all-gather of (B, S, D)) and sigmoid(r)
    times the summed v is formed once, whole, as the residual stream is."""
    mu = _whole(p, ("mu",), "channel mix")["mu"]
    xk = h + (prev.to(h.device) - h) * mu[0].to(h.dtype)
    xr = h + (prev.to(h.device) - h) * mu[1].to(h.dtype)
    _check(r, p["wk"], "column", "wk")
    _check(r, p["wv"], "row", "wv")
    _check(r, p["wr"], "column", "wr")

    def part(m, xkm, xrm):
        dev = r.dev(m)
        k = torch.square(torch.relu(dense({"w": p["wk"]["w"].at(r.at(m))}, xkm.to(dev))))
        return (dense({"w": p["wv"]["w"].at(r.at(m))}, k),
                dense({"w": p["wr"]["w"].at(r.at(m))}, xrm.to(dev)))

    ins = (model_copy(xk), model_copy(xr))
    outs = r.walk(part, lambda m: ins,
                  lambda m: [p[n]["w"].at(r.at(m)) for n in ("wk", "wv", "wr")])
    v = model_sum([o[0] for o in outs], dtype=h.dtype)
    rr = model_gather([o[1] for o in outs], -1)
    return torch.sigmoid(rr) * v


# --------------------------------------------------------------- Mamba ---
def _mamba_split(r: _Row, p: dict) -> None:
    """Raise NotImplementedError unless the Mamba mixer is split over its
    inner channels: in_proj and dt_proj column blocks, x_proj and out_proj
    row blocks, conv_w/conv_b/d over their channels and a_log over its
    rows."""
    _check(r, p["in_proj"], "column", "in_proj")
    _check(r, p["dt_proj"], "column", "dt_proj")
    _check(r, p["x_proj"], "row", "x_proj")
    _check(r, p["out_proj"], "row", "out_proj")
    for name, want in (("conv_w", "column"), ("conv_b", "column"), ("d", "column"),
                       ("a_log", "row")):
        got = _kind(p[name])
        if got != want and not (got == "whole" and r.n == 1):
            raise NotImplementedError(f"mamba {name}: a {got} split where the inner "
                                      f"channels split over {r.n} 'model' positions")


def _mamba(r: _Row, p: dict, h, cache=None, step: bool = False):
    """Mamba's mixer over one data block's normed h (B, S, D) over 'model'
    (``step``: one token from the cached conv window and h). in_proj's
    column blocks, re-split to each position's x and z channels; the
    causal conv and silu local; x_proj a row block, its partial sums
    through ``model_sum`` so that every position has the whole dt_low, B
    and C; dt_proj a column block; the selective scan over the position's
    channels; silu(z) local; out_proj a row block through ``model_sum``.
    With ``cache``, each position's conv window and h are written
    (prefill) or read and updated (step)."""
    cfg = r.cfg
    b, s, d = h.shape
    din, dc, ns = cfg.mamba_expand * d, cfg.mamba_d_conv, cfg.mamba_d_state
    rank = max(1, d // 16)
    _mamba_split(r, p)
    dl = din // r.n

    def blk(name, m):
        return p[name].at(r.at(m)) if isinstance(p[name], Placed) else p[name]["w"].at(r.at(m))

    hc = model_copy(h)
    # in_proj's column blocks are contiguous, so positions below |model| / 2
    # hold only x channels and the rest only z channels: an all-to-all gives
    # each position its x and z channels (its blocks of conv_w, conv_b, d,
    # a_log and dt_proj), in_proj itself keeping the reference's layout
    xz = model_all_to_all(r.walk(lambda m, hm: hm.to(r.dev(m)) @ blk("in_proj", m).to(h.dtype),
                                 lambda m: (hc,), lambda m: [blk("in_proj", m)]), -1)

    def conv(m, xzm):
        x_m = xzm[..., m * dl:(m + 1) * dl].to(r.dev(m))
        z_m = xzm[..., din + m * dl:din + (m + 1) * dl].to(r.dev(m))
        cw, cb = blk("conv_w", m), blk("conv_b", m)
        if step:
            window = torch.cat([cache["conv"].at(r.at(m)).to(x_m.dtype), x_m], dim=1)
            xi = S.conv_step(window, cw, cb, h.dtype)[:, None]
            cache["conv"].at(r.at(m)).copy_(window[:, 1:])
        else:
            xi, xpad = S.causal_conv(x_m, cw, cb, dc)
            if cache is not None:
                cache["conv"].at(r.at(m)).copy_(xpad[:, s:s + dc - 1])
        return xi, z_m, dense({"w": blk("x_proj", m)}, xi)

    outs = r.walk(conv, lambda m: (xz,), lambda m: [blk(n, m) for n in (
        "conv_w", "conv_b", "x_proj")] + ([cache["conv"].at(r.at(m))] if cache is not None
                                         else []))
    proj = model_copy(model_sum([o[2] for o in outs], dtype=h.dtype))

    def scan(m, xi, z, pm):
        dev = r.dev(m)
        dt, b_mat, c_mat = S.ssm_split(pm.to(dev), {"w": p["dt_proj"]["w"].at(r.at(m)),
                                                    "b": p["dt_proj"]["b"].at(r.at(m))},
                                       rank, ns)
        a_log, dd = blk("a_log", m), blk("d", m)
        if step:
            hm = cache["h"].at(r.at(m))
            y, new = S._mamba_step_core({"a_log": a_log, "d": dd}, xi[:, 0], dt[:, 0],
                                        b_mat[:, 0], c_mat[:, 0], hm)
            hm.copy_(new)
            y = y[:, None]
        else:
            y, new = S.selective_scan(xi, dt, b_mat, c_mat, a_log, dd)
            if cache is not None:
                cache["h"].at(r.at(m)).copy_(new)
        return dense({"w": p["out_proj"]["w"].at(r.at(m))}, y.to(h.dtype) * silu(z))

    parts = r.walk(scan, lambda m: (*outs[m][:2], proj), lambda m: [
        p["dt_proj"]["w"].at(r.at(m)), p["dt_proj"]["b"].at(r.at(m)), blk("a_log", m),
        blk("d", m), p["out_proj"]["w"].at(r.at(m))] + (
        [cache["h"].at(r.at(m))] if cache is not None else []))
    return _row_sum(parts, None, h.dtype)


# ---------------------------------------------------------- the stack ---
def _sublayer(r: _Row, spec: dict, p: dict, x, rope, cache=None, *, causal: bool = True,
              enc=None):
    """One sub-layer over a sequence, its mixer by ``spec["mixer"]`` as the
    reference's ``_apply_sublayer_seq`` (with the encoder's output ``enc``
    an attention sub-layer's cross-attention follows its self-attention);
    with ``cache`` (prefill) each mixer's decode state is written in
    ``cache_pspecs``' layout."""
    cfg = r.cfg
    h = apply_norm(p["ln1"], x, cfg.norm_eps)
    if spec["mixer"] == "attn":
        x = x + _attention(r, p["attn"], h, rope, cache, causal=causal)
        if enc is not None and "cross" in p:
            h = apply_norm(p["ln_x"], x, cfg.norm_eps)
            x = x + _attention(r, p["cross"], h, None, cache, xkv=enc)
    elif spec["mixer"] == "mamba":
        x = x + _mamba(r, p["mamba"], h, cache)
    else:
        x = x + _rwkv(r, p["rwkv"], h, cache)
    h = apply_norm(p["ln2"], x, cfg.norm_eps)
    if cache is not None and spec["ffn"] == "channel_mix":
        cache["cm_prev"].at({}).copy_(h[:, -1])
    y, stats = _ffn(r, spec, p, h)
    return x + y, stats


def _step_sublayer(r: _Row, spec: dict, p: dict, x, cache: dict, pos_b, rope, pos):
    """One sub-layer over one new token x (B, 1, D), its cache updated in
    place (``pos`` the scalar position a TaCo layer takes)."""
    cfg = r.cfg
    h = apply_norm(p["ln1"], x, cfg.norm_eps)
    if spec["mixer"] == "attn":
        if cfg.attention_kind == "taco" and "taco" in cache:
            x = x + _taco_attention(r, p["attn"], h, cache, pos_b, rope, pos)
        else:
            x = x + _decode_attention(r, p["attn"], h, cache, pos_b, rope)
        if "cross" in p and "cross_k" in cache:
            x = x + _decode_cross(r, p["cross"], apply_norm(p["ln_x"], x, cfg.norm_eps), cache)
    elif spec["mixer"] == "mamba":
        x = x + _mamba(r, p["mamba"], h, cache, step=True)
    else:
        x = x + _rwkv(r, p["rwkv"], h, cache, step=True)
    h = apply_norm(p["ln2"], x, cfg.norm_eps)
    if spec["ffn"] != "channel_mix":
        return x + _ffn(r, spec, p, h)[0]
    prev = cache["cm_prev"].at({})
    y = _ffn(r, spec, p, h, prev[:, None])[0]
    prev.copy_(h[:, 0])
    return x + y


def _replicated(tree):
    """The norms' blocks (replicated) as tensors."""
    return map_tree(lambda pl: pl.at({}), tree)


def _layer_params(gp: dict) -> dict:
    """A group view's sub-layer tree with the replicated norms as tensors
    and the split weights as :class:`Placed`."""
    out = {}
    for name, sub in gp.items():
        out[name] = _replicated(sub) if name.startswith("ln") else sub
    return out


def _group(r: _Row, specs, gp, x, enc=None, *, rope, caches=None, causal: bool = True):
    """The group's sub-layers over x (cross-attending ``enc``): (x, its MoE
    layers' routing statistics (n, 2, E), or None without MoE layers)."""
    stats = []
    for i, spec in enumerate(specs):
        x, st = _sublayer(r, spec, _layer_params(gp[f"l{i}"]), x, rope,
                          None if caches is None else caches[f"l{i}"], causal=causal, enc=enc)
        if st is not None:
            stats.append(st)
    return x, torch.stack(stats) if stats else None


def _stack(r: _Row, blocks, n: int, specs, x, rope, *, remat: bool, caches=None,
           causal: bool = True, enc=None):
    """The ``n`` stacked groups of ``blocks`` over x: (x, the MoE layers'
    routing statistics (L, 2, E), or None)."""
    groups = _groups(blocks, n)
    cgroups = None if caches is None else _groups(caches, n)
    stats = []
    for g, gp in enumerate(groups):
        run = functools.partial(_group, r, specs, gp, rope=rope,
                                caches=None if cgroups is None else cgroups[g], causal=causal)
        if remat:
            # the whole group is recomputed, as at every position alone (an
            # early stop would end at the last position's last saved input)
            with set_checkpoint_early_stop(False):
                x, st = checkpoint(run, x, enc, use_reentrant=False,
                                   context_fn=recompute_context)
        else:
            x, st = run(x, enc)
        if st is not None:
            stats.append(st)
    return x, torch.cat(stats) if stats else None


def _run_stack(r: _Row, params, x, rope, *, remat: bool, caches=None, enc=None):
    """The decoder stack: (x, the MoE layers' routing statistics (L, 2, E),
    or None)."""
    cfg = r.cfg
    return _stack(r, params["blocks"], cfg.n_groups, cfg.layer_specs(), x, rope, remat=remat,
                  caches=caches, enc=enc)


def _encode(r: _Row, params, frames, remat: bool):
    """whisper's encoder over one data block's frame embeddings (B, T, D):
    the learned positions added and the final norm taken once, outside the
    positions (replicated, as the residual stream is); each layer's
    non-causal self-attention and MLP split over 'model' as the decoder's.
    The output is replicated over the positions, each position's
    cross-attention reading it (:func:`model_copy`: its gradient is the sum
    over the positions)."""
    cfg = r.cfg
    enc = params["encoder"]
    pos = enc["pos"].at({})
    x = (frames.to(r.home, cfg.cdtype)
         + pos[None, :frames.shape[1]].to(r.home, cfg.cdtype))
    x, _ = _stack(r, enc["blocks"], cfg.encoder_layers, [_ENC_SPEC], x, None, remat=remat,
                  causal=False)
    return apply_norm(_replicated(enc["norm"]), x, cfg.norm_eps)


def _inputs(r: _Row, params, batch: dict, what: str, remat: bool = False):
    """(x, n_patches, enc): the block's embeddings behind a vlm's patches,
    with the learned decoder positions where the config has them, and the
    audio encoder's output (or None)."""
    cfg = r.cfg
    x = _embed(r, params["embed"]["table"], batch["tokens"]).to(cfg.cdtype)
    inputs = _frontend(cfg, batch, what)
    n_patches, enc = 0, None
    if cfg.frontend == "audio":
        enc = _encode(r, params, inputs, remat)
    elif inputs is not None:
        n_patches = inputs.shape[1]
        x = torch.cat([inputs.to(x.device, cfg.cdtype), x], dim=1)
    if not cfg.use_rope and "dec_pos" in params:
        x = x + params["dec_pos"].at({})[None, :x.shape[1]].to(x.device, cfg.cdtype)
    return x, n_patches, enc


def _rope(cfg: ArchConfig, positions):
    return rope_angles(positions, cfg.hd, cfg.rope_theta) if cfg.use_rope else None


def _head(r: _Row, params, x):
    """Each position's logits of its vocabulary columns that are real
    (below ``vocab_size``), float32: [(logits (B, S, n_m), first column)]."""
    cfg = r.cfg
    head = params["lm_head"]
    _check(r, head, "column", "lm_head")
    x = apply_norm(_replicated(params["final_norm"]), x, cfg.norm_eps)

    def part(m, xm):
        w = head["w"].at(r.at(m))
        lo = m * w.shape[-1] if _kind(head["w"]) == "column" else 0
        n = max(0, min(lo + w.shape[-1], cfg.vocab_size) - lo)
        return dense({"w": w[:, :n]}, xm.to(w.device)).to(torch.float32)

    x = model_copy(x)
    blocks = r.walk(part, lambda m: (x,), lambda m: [head["w"].at(r.at(m))],
                    even=cfg.vocab_size == cfg.padded_vocab)
    width = head["w"].at(r.at(0)).shape[-1]
    return [(blk, m * width if _kind(head["w"]) == "column" else 0)
            for m, blk in enumerate(blocks)]


def _vocab_parallel_cross_entropy(r: _Row, blocks, labels, denom, z_loss: float = 1e-4):
    """The next-token cross entropy (:func:`repro_torch.train.losses.cross_entropy`)
    of one data block over logits split by vocabulary columns, summed over
    the block and divided by ``denom`` (the whole batch's count of labels):
    each position's max and sum of exp over its columns, combined by
    ``model_max`` and ``model_sum``; the label's logit from the position
    that owns it. No position holds the (B, S, V) logits."""
    mask = (labels != IGNORE).to(torch.float32)
    safe = torch.clamp_min(labels, 0).long()
    mx = model_max([blk.detach().amax(-1) if blk.shape[-1] else
                    torch.full(blk.shape[:-1], -torch.inf, device=blk.device)
                    for blk, _lo in blocks])

    def part(m, blk, mxm):
        lo = blocks[m][1]
        if not blk.shape[-1]:
            return torch.zeros((2, *blk.shape[:-1]), dtype=torch.float32, device=blk.device)
        sumexp = torch.exp(blk - mxm[..., None]).sum(-1)
        local = safe.to(blk.device) - lo
        inside = (local >= 0) & (local < blk.shape[-1])
        gold = torch.gather(blk, -1, local.clamp(0, blk.shape[-1] - 1)[..., None])[..., 0]
        return torch.stack([sumexp, torch.where(inside, gold, 0.0)])

    parts = r.walk(part, lambda m: (blocks[m][0], mx), lambda m: [],
                   even=len({blk.shape for blk, _ in blocks}) == 1)
    sumexp, gold = model_sum(parts)
    lse = torch.log(sumexp) + mx
    nll = (lse - gold) * mask
    loss = torch.sum(nll) / denom
    if z_loss:
        loss = loss + z_loss * torch.sum((lse * mask) ** 2) / denom
    return loss


def _data_blocks(mesh: DeviceMesh, data_axes, batch: dict, cache=None):
    """(blocks, rows a block, the data coordinates of block d). A decode
    step's one-row batch (``cache`` given) that the data positions cannot
    split is one block that all of them serve, its coordinates {} (the
    reference's sanitized spec replicates a (1, 1) token tensor), where the
    cache allows it (:func:`_one_row_cache`)."""
    n = axis_size(mesh, tuple(data_axes))
    rows = next(iter(batch.values())).shape[0]
    if rows % n == 0:
        return n, rows // n, lambda d: _row_coords(mesh, data_axes, d)
    if rows == 1 and cache is not None and _one_row_cache(cache, data_axes):
        return 1, 1, lambda d: {}
    raise ValueError(f"a batch of {rows} rows does not split over {n} data positions")


def _row_coords(mesh, data_axes, d: int) -> dict:
    return mesh.coords([tuple(data_axes)], [d])


def _one_row_cache(cache, data_axes) -> bool:
    """Whether a placed cache serves one row from every data position:
    each attention layer's K/V sequence split over the data axes and
    'model' (context parallelism, the first axis the major one), and no
    leaf's batch split over a data axis (the TaCo state's mean, basis and
    centroids have no batch)."""
    for c in cache.values():
        for name, pl in c.items():
            if name in ("k", "v") and entry_axes(pl.spec[2]) != (*data_axes, MODEL):
                return False
            leaves = ([c[name].cells, c[name].cell_sizes] if name == "taco" else [pl])
            if any(a in data_axes for leaf in leaves for a in entry_axes(leaf.spec[1])):
                return False
    return True


def block_loss(params, cfg: ArchConfig, batch: dict, mesh: DeviceMesh, row: dict, denom, *,
               impl: str = "auto"):
    """One data block's share of the train loss (its rows of ``batch``,
    {'tokens', 'labels'}, a vlm's 'patch_embeds' and an audio config's
    'frames'), with its row of 'model' positions at ``row``: (a
    vocab-parallel cross entropy over the head's column blocks, divided by
    ``denom``; the MoE layers' routing statistics (L, 2, E) for
    :func:`moe_aux`, or None)."""
    check_supported(cfg)
    r = _Row(cfg, mesh, row, impl)
    remat = cfg.remat and torch.is_grad_enabled()
    x, n_patches, enc = _inputs(r, params, batch, "forward", remat)
    x, stats = _run_stack(r, params, x, _rope(cfg, torch.arange(x.shape[1], device=x.device)),
                          remat=remat, enc=enc)
    blocks = [(blk[:, n_patches:], lo) for blk, lo in _head(r, params, x)]
    return _vocab_parallel_cross_entropy(r, blocks, batch["labels"].to(x.device), denom), stats


def sharded_forward(params, cfg: ArchConfig, batch: dict, mesh: DeviceMesh, *,
                    data_axes=("data",), impl: str = "auto"):
    """``forward`` over placed parameters: (logits (B, S, V) float32, aux
    float32: :func:`moe_aux`, 0 without MoE layers). The logits are
    gathered over 'model' for the caller; the train step never gathers
    them (:func:`block_loss`)."""
    check_supported(cfg)
    n, size, rows = _data_blocks(mesh, data_axes, batch)

    def one(d):
        r = _Row(cfg, mesh, rows(d), impl)
        part = {k: v[d * size:(d + 1) * size].to(r.home) for k, v in batch.items()}
        x, n_patches, enc = _inputs(r, params, part, "forward")
        x, stats = _run_stack(r, params, x,
                              _rope(cfg, torch.arange(x.shape[1], device=x.device)),
                              remat=False, enc=enc)
        logits = model_gather([blk for blk, _ in _head(r, params, x)], -1)[:, n_patches:]
        return logits, stats, x.shape[0] * x.shape[1]

    outs = walk(n, rows, one)
    home = outs[0][0].device
    logits = torch.cat([o.to(home) for o, _, _ in outs])
    if outs[0][1] is None:
        return logits, torch.zeros((), dtype=torch.float32, device=home)
    return logits, moe_aux(cfg, [st for _, st, _ in outs], outs[0][2])[0].to(home)


# ============================================================ inference ==
def sharded_init_cache(cfg: ArchConfig, batch_size: int, max_seq: int, mesh: DeviceMesh, *,
                       data_axes=("data",), device=None, enc_len: int = 0) -> dict:
    """The decode cache placed in :func:`~repro_torch.launch.sharding.cache_pspecs`'
    layout (sanitized), zeros made block by block (``enc_len``: an enc-dec
    config's encoder frames, default its ``frontend_len``). An attention
    layer's K/V must come out split along the sequence over 'model' or, for
    a one-row batch the data positions do not split, over the data axes and
    'model' (context parallelism); the cross cache is read along the frames
    or along head_dim (:func:`_cross_dim`) (Mamba's conv and h split over the inner channels,
    RWKV's WKV state over the heads, the token shifts and the TaCo state's
    cells replicated, its mean, basis and centroids as the default rule
    splits them)."""
    check_supported(cfg, decode=True)
    shapes = init_cache(cfg, batch_size, max_seq, enc_len=enc_len, device="meta")
    specs = cache_specs(shapes, mesh, data_axes)
    cache = tree_map(lambda t, s: placed_zeros(t.shape, t.dtype, s, mesh, device), shapes,
                     specs)
    one_row = batch_size == 1 and axis_size(mesh, tuple(data_axes)) > 1
    for c in cache.values():
        for name in ("k", "v") if "k" in c else ():
            seq = entry_axes(c[name].spec[2])
            sequence = MODEL in seq and all(mesh.shape[a] == 1 for a in seq if a != MODEL)
            if not sequence and not (one_row and seq == (*data_axes, MODEL)):
                raise NotImplementedError(
                    f"a cache split {c[name].spec}: sharded decode splits the sequence over "
                    "'model', or a one-row batch's over the data axes and 'model'")
    return cache


def sharded_prefill(params, cfg: ArchConfig, batch: dict, max_seq: int, mesh: DeviceMesh, *,
                    data_axes=("data",), impl: str = "auto"):
    """``prefill`` over placed parameters: (last logits (B, 1, V) float32,
    the cache placed in ``cache_pspecs``' layout, written; an enc-dec
    config's cross cache along the frames or along head_dim, as the mesh
    sanitizes it)."""
    check_supported(cfg)
    n, size, rows = _data_blocks(mesh, data_axes, batch)
    on_meta = next(iter(params["embed"]["table"].blocks.values())).is_meta
    enc_len = batch["frames"].shape[1] if cfg.frontend == "audio" and "frames" in batch else 0
    cache = sharded_init_cache(cfg, n * size, max_seq, mesh, data_axes=data_axes,
                               device="meta" if on_meta else None, enc_len=enc_len)

    def one(d):
        r = _Row(cfg, mesh, rows(d), impl)
        part = {k: v[d * size:(d + 1) * size].to(r.home) for k, v in batch.items()}
        x, _, enc = _inputs(r, params, part, "prefill")
        x, _stats = _run_stack(r, params, x,
                               _rope(cfg, torch.arange(x.shape[1], device=x.device)),
                               remat=False, caches=_row_view(cache, r), enc=enc)
        blocks = _head(r, params, x[:, -1:])
        return model_gather([blk for blk, _ in blocks], -1)

    with torch.no_grad():
        outs = walk(n, rows, one, lambda d: [v[d * size:(d + 1) * size] for v in batch.values()])
    home = outs[0].device
    return torch.cat([o.to(home) for o in outs]), cache


def _row_view(cache, r: _Row):
    """The cache tree with each :class:`Placed` cut to the row's blocks
    (keys over 'model' only), so the group views index one row. Left
    whole: a one-row batch's K/V (context parallelism: their blocks over
    the data axes and 'model') and the TaCo state's mean, basis and
    centroids (gathered where a step reads them)."""
    def cut(pl: Placed) -> Placed:
        spec = tuple(MODEL if MODEL in entry_axes(e) else None for e in pl.spec)
        if MODEL not in spec:  # replicated over 'model' (RWKV's token shifts)
            return Placed(spec, pl.shape, pl.dtype, pl.mesh, {(): pl.at(r.at(0))})
        blocks = {(m,): pl.at(r.at(m)) for m in range(r.n)}
        return Placed(spec, pl.shape, pl.dtype, pl.mesh, blocks)

    def layer(c: dict) -> dict:
        out = {}
        for name, leaf in c.items():
            if name == "taco":
                out[name] = dataclasses.replace(leaf, cells=cut(leaf.cells),
                                                cell_sizes=cut(leaf.cell_sizes))
            elif name in ("k", "v") and not r.row:
                out[name] = leaf
            else:
                out[name] = cut(leaf)
        return out

    return {name: layer(c) for name, c in cache.items()}


def sharded_decode_step(params, cfg: ArchConfig, cache: dict, tokens, pos, mesh: DeviceMesh, *,
                        data_axes=("data",)):
    """``decode_step`` over placed parameters and a cache in
    ``cache_pspecs``' layout: (logits (B, 1, V) float32, cache), the new
    token's K/V written in place into the position that owns ``pos`` (an
    int, or a (B,) tensor per sequence; one scalar for TaCo attention, as
    on one device). A one-row batch whose K/V sequence is split over the
    data axes and 'model' runs as one block over every position
    (:func:`_data_blocks`): its projections over 'model' once for all data
    positions, its attention over each position's block of the
    sequence."""
    check_supported(cfg, decode=True)
    n, size, rows = _data_blocks(mesh, data_axes, {"tokens": tokens}, cache)
    if cfg.attention_kind == "taco":
        if (pos.dim() if torch.is_tensor(pos) else np.ndim(pos)) > 0:
            raise ValueError("TaCo decode takes one scalar pos for the whole batch, as on one "
                             "device")
        pos = int(pos)

    def one(d):
        r = _Row(cfg, mesh, rows(d), "torch")
        toks = tokens[d * size:(d + 1) * size].to(r.home)
        pos_b = torch.as_tensor(pos, dtype=torch.long, device=r.home)
        if pos_b.dim():
            pos_b = pos_b[d * size:(d + 1) * size]
        pos_b = pos_b.expand(size)
        x = _embed(r, params["embed"]["table"], toks).to(cfg.cdtype)
        if not cfg.use_rope and "dec_pos" in params:
            x = x + params["dec_pos"].at({})[pos_b.to(x.device)][:, None].to(cfg.cdtype)
        rope = _rope(cfg, pos_b[:, None])
        caches = _groups(_row_view(cache, r), cfg.n_groups)
        for g, gp in enumerate(_groups(params["blocks"], cfg.n_groups)):
            for i, spec in enumerate(cfg.layer_specs()):
                x = _step_sublayer(r, spec, _layer_params(gp[f"l{i}"]), x, caches[g][f"l{i}"],
                                   pos_b, rope, pos)
        blocks = _head(r, params, x)
        return model_gather([blk for blk, _ in blocks], -1)

    with torch.no_grad():
        outs = walk(n, rows, one, lambda d: [tokens[d * size:(d + 1) * size]])
    home = outs[0].device
    return torch.cat([o.to(home) for o in outs]), cache


def _seq_blocks(r: _Row, pl: Placed) -> list:
    """The blocks of a K/V leaf (a group view of the row's cache, (B, S,
    kv, hd)) in sequence order: [(the owning position's coordinates, the
    block's first slot, the block's key)], the sequence split over 'model'
    or, for a one-row batch, over the data axes and 'model'."""
    out = []
    for key in pl.keys():
        coords = pl.coords(key)
        start = block_slices(pl.shape, pl.spec, pl.mesh, coords)[1].start
        out.append(({**r.row, **coords}, start, key))
    return sorted(out, key=lambda e: e[1])


def _decode_qkv(r: _Row, p: dict, h, rope):
    """The new token's q (B, 1, H, hd), k and v (B, 1, Kv, hd): the column
    blocks gathered over 'model', q and k with RoPE."""
    cfg = r.cfg
    b = h.shape[0]
    cols = _qkv_columns(r, p, h)
    q = model_gather([c[0] for c in cols], -1).reshape(b, 1, cfg.n_heads, cfg.hd)
    k = model_gather([c[1] for c in cols], -1).reshape(b, 1, cfg.n_kv_heads, cfg.hd)
    v = model_gather([c[2] for c in cols], -1).reshape(b, 1, cfg.n_kv_heads, cfg.hd)
    if rope is not None:
        q, k = apply_rope(q, *rope), apply_rope(k, *rope)
    return q, k, v


def _write_token(ck, cv, k, v, pos_b, start: int):
    """The new token's k, v (B, 1, Kv, hd) written at ``pos_b`` into a
    sequence block starting at ``start``: a masked write at every block
    (each position does the same work; the one that owns ``pos_b`` keeps
    it)."""
    size = ck.shape[1]
    rows = torch.arange(ck.shape[0], device=ck.device)
    local = pos_b.to(ck.device) - start
    here = (local >= 0) & (local < size)
    slot = local.clamp(0, size - 1)
    for dst, new in ((ck, k), (cv, v)):
        dst[rows, slot] = torch.where(here[:, None, None], new[:, 0].to(dst.device, dst.dtype),
                                      dst[rows, slot])


def _out_rows(r: _Row, wo: dict, out, dtype):
    """``wo``'s row blocks over the whole attention output (B, 1, H·hd):
    each position's rows of it, the partial sums through ``model_sum``."""
    rows_per = out.shape[-1] // r.n

    def proj(m, o):
        return dense({"w": wo["w"].at(r.at(m))}, o[..., m * rows_per:(m + 1) * rows_per])

    partials = r.walk(proj, lambda m: (out,), lambda m: [wo["w"].at(r.at(m))])
    return _row_sum(partials, _bias(wo, dtype), dtype)


def _decode_attention(r: _Row, p: dict, h, cache: dict, pos_b, rope):
    """One new token's attention over the sequence-split cache."""
    cfg = r.cfg
    b = h.shape[0]
    heads, hd = cfg.n_heads, cfg.hd
    _check(r, p["wo"], "row", "wo")
    q, k, v = _decode_qkv(r, p, h, rope)
    blocks = _seq_blocks(r, cache["k"])

    def part(i):
        _coords, start, key = blocks[i]
        ck, cv = cache["k"].blocks[key], cache["v"].blocks[key]
        size = ck.shape[1]
        _write_token(ck, cv, k, v, pos_b, start)
        scores = A.gqa_scores(q.to(ck.device), ck).to(torch.float32)  # (B,Kv,G,1,size)
        seen = (start + torch.arange(size, device=ck.device)[None, :]
                <= pos_b.to(ck.device)[:, None])
        scores = torch.where(seen[:, None, None, None, :], scores, A.NEG_INF)
        mx = scores.amax(-1, keepdim=True)
        e = torch.exp(scores - mx)
        num = torch.einsum("bkgst,btkd->bkgsd", e.to(q.dtype), cv)
        return mx, e.sum(-1, keepdim=True), num

    parts = walk(len(blocks), lambda i: blocks[i][0], part,
                 lambda i: [q, cache["k"].blocks[blocks[i][2]], cache["v"].blocks[blocks[i][2]]])
    out = lse_combine(parts)  # (B, Kv, G, 1, hd)
    out = out.permute(0, 3, 1, 2, 4).reshape(b, 1, heads * hd).to(h.dtype)
    return _out_rows(r, p["wo"], out, h.dtype)


def _decode_cross(r: _Row, p: dict, h, cache: dict):
    """One new token's cross-attention (h normed by ``ln_x``) over the
    row's cross cache as it is placed. Along the frames: each position's
    partial softmax sums over its frames, merged by ``lse_combine``. Along
    head_dim: each position's q·kᵀ over its head_dim slice for every head,
    summed in float32 through ``model_sum`` into the whole scores, the
    softmax taken once (every position holds the scores), each position's
    head_dim slice of probs·v gathered. Then ``wo``'s row blocks."""
    cfg = r.cfg
    b = h.shape[0]
    heads, kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    g = heads // kv
    _check(r, p["wq"], "column", "wq")
    _check(r, p["wo"], "row", "wo")
    ck_pl, cv_pl = cache["cross_k"], cache["cross_v"]
    dim = _cross_dim(ck_pl)
    hc = model_copy(h)
    leaves = [p["wq"][k] for k in ("w", "b") if k in p["wq"]]
    cols = r.walk(lambda m, hm: dense(r.local({"wq": p["wq"]}, m)["wq"], hm.to(r.dev(m))),
                  lambda m: (hc,), lambda m: [pl.at(r.at(m)) for pl in leaves])
    q = model_gather(cols, -1).reshape(b, 1, heads, hd)
    if dim != 3:
        def part(m, qm):
            ck, cv = ck_pl.at(r.at(m)), cv_pl.at(r.at(m))
            scores = A.gqa_scores(qm.to(ck.device), ck).to(torch.float32)  # (B,Kv,G,1,Tm)
            mx = scores.amax(-1, keepdim=True)
            e = torch.exp(scores - mx)
            num = torch.einsum("bkgst,btkd->bkgsd", e.to(qm.dtype), cv)
            return mx, e.sum(-1, keepdim=True), num

        parts = r.walk(part, lambda m: (q,),
                       lambda m: [ck_pl.at(r.at(m)), cv_pl.at(r.at(m))])
        out = lse_combine(parts).permute(0, 3, 1, 2, 4)  # (B, 1, Kv, G, hd)
    else:
        width = hd // r.n
        qg = q.reshape(b, 1, kv, g, hd)

        def scores(m, qm):
            ck = ck_pl.at(r.at(m))
            qs = qm[..., m * width:(m + 1) * width].to(ck.device, torch.float32)
            return torch.einsum("bskgd,btkd->bkgst", qs, ck.to(torch.float32))

        partial = r.walk(scores, lambda m: (qg,), lambda m: [ck_pl.at(r.at(m))])
        probs = torch.softmax(model_sum(partial) * hd**-0.5, dim=-1).to(q.dtype)

        def values(m, pm):
            cv = cv_pl.at(r.at(m))
            return torch.einsum("bkgst,btkd->bskgd", pm.to(cv.device), cv)

        out = model_gather(r.walk(values, lambda m: (probs,), lambda m: [cv_pl.at(r.at(m))]),
                           -1)  # (B, 1, Kv, G, hd)
    out = out.reshape(b, 1, heads * hd).to(h.dtype)
    return _out_rows(r, p["wo"], out, h.dtype)


def _gathered(pl: Placed) -> torch.Tensor:
    """A leaf split over the data axes (the TaCo state's mean, basis and
    centroids) whole: its blocks gathered once for the step, an
    all-gather of the whole leaf (nothing moves where it has one
    block)."""
    if len(pl.blocks) == 1:
        return next(iter(pl.blocks.values()))
    with one_pass() as moves:
        first = next(iter(pl.blocks.values()))
        out = torch.empty(pl.shape, dtype=pl.dtype, device=first.device)
        for key, blk in pl.blocks.items():
            out[block_slices(pl.shape, pl.spec, pl.mesh, pl.coords(key))] = blk.to(out.device)
        moves(first, out)
    tally("all-gather", tensor_bytes(out))
    return out


def _taco_attention(r: _Row, p: dict, h, cache: dict, pos_b, rope, pos: int):
    """One new token's TaCo retrieval attention over the sequence-split
    cache (:func:`repro_torch.models.taco_attention.taco_decode_attention`
    step by step): q, k, v gathered with RoPE at ``pos``; the new K/V
    written into the owning position; the state's mean, basis and centroids
    gathered whole; the new key's cells and their counts in the one
    replicated copy of ``cells`` and ``cell_sizes``; then once, outside the
    positions, over the whole sequence, the slot selection
    (:func:`~repro_torch.models.taco_attention.select_slots`). Each
    position gathers the selected slots that fall in its block and returns
    (max, sum, numerator) over them; one that holds none returns (NEG_INF,
    0, 0), which adds nothing to ``lse_combine``. Then ``wo``'s row
    blocks."""
    cfg, rc = r.cfg, r.cfg.retrieval
    b = h.shape[0]
    heads, kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    g = heads // kv
    _check(r, p["wo"], "row", "wo")
    q, k, v = _decode_qkv(r, p, h, rope)
    st = cache["taco"]
    state = TA.RetrievalState(mean=_gathered(st.mean), basis=_gathered(st.basis),
                              centroids=_gathered(st.centroids), cells=st.cells.at(r.at(0)),
                              cell_sizes=st.cell_sizes.at(r.at(0)))
    TA.insert_key(state, k, pos, rc)
    top_idx, sel_valid = TA.select_slots(q, state, pos, rc, cache["k"].shape[1])
    c = top_idx.shape[-1]
    blocks = _seq_blocks(r, cache["k"])
    qg = q.reshape(b, 1, kv, g, hd).permute(0, 2, 3, 1, 4)

    def part(i):
        _coords, start, key = blocks[i]
        ck, cv = cache["k"].blocks[key], cache["v"].blocks[key]
        size, dev = ck.shape[1], ck.device
        _write_token(ck, cv, k, v, pos_b, start)
        local = top_idx.to(dev) - start
        inside = ((local >= 0) & (local < size) & sel_valid.to(dev))[..., None, :]
        at = local.clamp(0, size - 1)[..., None].expand(b, kv, g, c, hd)
        gk = torch.gather(ck.transpose(1, 2)[:, :, None].expand(b, kv, g, size, hd), 3, at)
        gv = torch.gather(cv.transpose(1, 2)[:, :, None].expand(b, kv, g, size, hd), 3, at)
        # the one-device path's rounding: q in the cache dtype, the products in float32
        scores = torch.einsum("bkgsd,bkgcd->bkgsc", qg.to(dev, ck.dtype).to(torch.float32),
                              gk.to(torch.float32)) * (hd**-0.5)
        scores = torch.where(inside, scores, TA.NEG_INF)
        mx = scores.amax(-1, keepdim=True)  # NEG_INF where the block holds no selected slot
        e = torch.where(inside, torch.exp(scores - mx), 0.0)
        num = torch.einsum("bkgsc,bkgcd->bkgsd", e.to(q.dtype), gv)
        return mx, e.sum(-1, keepdim=True), num

    parts = walk(len(blocks), lambda i: blocks[i][0], part,
                 lambda i: [qg, top_idx, cache["k"].blocks[blocks[i][2]],
                            cache["v"].blocks[blocks[i][2]]])
    out = lse_combine(parts)  # (B, Kv, G, 1, hd)
    out = out.permute(0, 3, 1, 2, 4).reshape(b, 1, heads * hd).to(h.dtype)
    return _out_rows(r, p["wo"], out, h.dtype)
