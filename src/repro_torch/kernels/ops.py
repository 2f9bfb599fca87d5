"""Public wrappers over the kernels (mirrors ``repro.kernels.ops``).

``impl`` selects:

  'auto'   — the CUDA kernel for a tensor on the card, the plain PyTorch
             version for a tensor on the CPU,
  'kernel' — the CUDA kernel (raises for a CPU tensor),
  'torch'  — the plain PyTorch version, on whatever device the tensor is.

The kernel wrappers count their launches in
:data:`repro_torch.kernels.cuda.launch_counts`. ``schist`` and
``masked_rerank`` take their (bq, bn) tiles from ``blocks=`` or, without
it, from the autotune cache (:mod:`repro_torch.kernels.autotune`) keyed by
the call's device type and shape; the plain path ignores them.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import autotune
from repro_torch.kernels.activation import sort_activation_cuda
from repro_torch.kernels.flash_attention import (
    FlashAttentionFunction,
    flash_attention_cuda,
    flash_attention_plain,
)
from repro_torch.kernels.kmeans_assign import (
    kmeans_assign_cuda,
    kmeans_assign_pairs_cuda,
    kmeans_assign_pairs_plain,
    kmeans_assign_plain,
)
from repro_torch.kernels.l2dist import (
    l2dist_cuda,
    l2dist_pairs_cuda,
    l2dist_pairs_plain,
    l2dist_plain,
)
from repro_torch.kernels.masked_rerank import (
    finalize_topk,
    masked_rerank_cuda,
    masked_rerank_plain,
)
from repro_torch.kernels.ref import sort_activation_ref
from repro_torch.kernels.schist import schist_cuda, schist_plain
from repro_torch.kernels.scscore import scscore_cuda, scscore_plain
from repro_torch.utils import round_bf16


def _use_kernel(impl: str, t: torch.Tensor) -> bool:
    if impl == "auto":
        return t.device.type == "cuda"
    if impl == "kernel":
        return True
    if impl == "torch":
        return False
    raise ValueError(f"unknown impl {impl!r}")


def _f32(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.float32).contiguous()


def l2dist(x, y, impl: str = "auto") -> torch.Tensor:
    """Squared L2 distance matrix (M, N) between rows of x (M,d), y (N,d)."""
    if not _use_kernel(impl, x):
        return l2dist_plain(x, y)
    return l2dist_cuda(_f32(x), _f32(y))


def l2dist_pairs(x, slices, y, impl: str = "auto") -> torch.Tensor:
    """Squared L2 distances (P, M, N) for a list of pairs: pair p compares
    the columns ``slices[p] = (col, dim)`` of x (M, D) with ``y[p, :, :dim]``
    of the zero-padded y (P, N, d_max). One kernel launch on the card."""
    if not _use_kernel(impl, x):
        return l2dist_pairs_plain(x, slices, y)
    return l2dist_pairs_cuda(_f32(x), slices, _f32(y))


def kmeans_assign(x, c, impl: str = "auto"):
    """(assignments (n,) int32, min sq dist (n,) f32)."""
    if not _use_kernel(impl, x):
        return kmeans_assign_plain(x, c)
    return kmeans_assign_cuda(_f32(x), _f32(c))


def kmeans_assign_pairs(xs, cs, dims=None, impl: str = "auto"):
    """(assignments (P, n) int32, min sq dists (P, n) f32) for P pairs
    zero-padded to one width, pair p being ``xs[p, :, :dims[p]]`` against
    ``cs[p, :, :dims[p]]``. One kernel launch on the card."""
    if not _use_kernel(impl, xs):
        return kmeans_assign_pairs_plain(xs, cs, dims)
    return kmeans_assign_pairs_cuda(_f32(xs), _f32(cs), dims)


def schist(bits, cells, n_levels: int, *, q: int, impl: str = "auto",
           blocks: tuple[int, int] | None = None) -> torch.Tensor:
    """Per-query SC-score histogram (q, n_levels) int32 from the packed
    collision table ``bits`` and the (N_s, n) cell ids. ``blocks``
    overrides the kernel's (bq, bn); when None the autotune cache is
    consulted (keyed f32)."""
    if not _use_kernel(impl, bits):
        return schist_plain(bits, cells, n_levels, q=q)
    if blocks is None:
        blocks = autotune.get_blocks("schist", "f32", q=q, n=cells.shape[1],
                                     backend=bits.device.type)
    return schist_cuda(bits.contiguous(), cells.contiguous(), n_levels, q=q, blocks=blocks)


def scscore(bits, cells, *, q: int, impl: str = "auto") -> torch.Tensor:
    """Full SC-score matrix (q, n) int32 from the packed collision table
    ``bits`` and the (N_s, n) cell ids."""
    if not _use_kernel(impl, bits):
        return scscore_plain(bits, cells, q=q)
    return scscore_cuda(bits.contiguous(), cells.contiguous(), q=q)


def sort_activation(d1s, d2s, sizes, alpha_n, impl: str = "auto"):
    """Sort activation of every (subspace, query) problem: (taus (N_s, Q),
    retrieved (N_s, Q)) float32 from d1s, d2s (N_s, Q, sqrt_k) and the
    subspaces' sizes (N_s, sqrt_k, sqrt_k) (int32 on the kernel route). The
    kernel (one launch on the card) returns the plain version's bits."""
    if not _use_kernel(impl, d1s):
        return sort_activation_ref(d1s, d2s, sizes[:, None], alpha_n)
    return sort_activation_cuda(_f32(d1s), _f32(d2s), sizes.contiguous(), alpha_n)


def masked_rerank(bits, cells, thresh, data, data_norms, queries, k: int,
                  impl: str = "auto", precision: str = "f32", exclude=None,
                  blocks: tuple[int, int] | None = None):
    """Masked re-rank: ((Q, k) ids int32, (Q, k) exact sq dists f32).

    ``blocks`` overrides the kernel's (bq, bn); when None the autotune
    cache is consulted (keyed by ``precision``).

    ``exclude`` is an exclusion bitmap
    (:func:`repro_torch.kernels.masked_rerank.pack_exclusion`, on the data's
    device) of points that never pass the mask, or None.

    ``precision="bf16"`` rounds the query and data operands through bfloat16
    before the float32 kernel (or plain version), as the reference's jnp
    path does; the norms stay the exact float32 ones, and finalize_topk
    recomputes the returned distances from the original vectors."""
    q_op, x_op = _f32(queries), _f32(data)
    if precision == "bf16":
        q_op, x_op = round_bf16(q_op), round_bf16(x_op)
    thresh = thresh.to(torch.int32).contiguous()
    norms = _f32(data_norms)
    if _use_kernel(impl, bits):
        if blocks is None:
            blocks = autotune.get_blocks("masked_rerank", precision, q=queries.shape[0],
                                         n=data.shape[0], backend=bits.device.type)
        bd, bi = masked_rerank_cuda(bits.contiguous(), cells.contiguous(), thresh,
                                    q_op, x_op, norms, k,
                                    None if exclude is None else exclude.contiguous(),
                                    blocks=blocks)
    else:
        bd, bi = masked_rerank_plain(bits, cells, thresh, q_op, x_op, norms, k, exclude)
    return finalize_topk(bd, bi, data, queries, k)


def flash_attention(q, k, v, causal: bool = True, impl: str = "auto") -> torch.Tensor:
    """Fused softmax attention (BH, S, hd) in q's dtype; the (S, T) scores
    never reach device memory. The kernel masks ragged S and T itself, so
    they are never padded. Where an input requires a gradient the launch
    goes through :class:`FlashAttentionFunction` (the gradient of the plain
    version); else it is the bare launch."""
    if not _use_kernel(impl, q):
        return flash_attention_plain(q, k, v, causal)
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        return FlashAttentionFunction.apply(q, k, v, causal, flash_attention_cuda)
    return flash_attention_cuda(q, k, v, causal)
