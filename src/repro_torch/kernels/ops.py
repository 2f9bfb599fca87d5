"""Public wrappers over the kernels (mirrors ``repro.kernels.ops``).

``impl`` selects:

  'auto'   — the CUDA kernel for a tensor on the card, the plain PyTorch
             version for a tensor on the CPU,
  'kernel' — the CUDA kernel (raises for a CPU tensor),
  'torch'  — the plain PyTorch version, on whatever device the tensor is.

The kernel wrappers count their launches in
:data:`repro_torch.kernels.cuda.launch_counts`.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention import flash_attention_cuda, flash_attention_plain
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


def schist(bits, cells, n_levels: int, *, q: int, impl: str = "auto") -> torch.Tensor:
    """Per-query SC-score histogram (q, n_levels) int32 from the packed
    collision table ``bits`` and the (N_s, n) cell ids."""
    if not _use_kernel(impl, bits):
        return schist_plain(bits, cells, n_levels, q=q)
    return schist_cuda(bits.contiguous(), cells.contiguous(), n_levels, q=q)


def scscore(bits, cells, *, q: int, impl: str = "auto") -> torch.Tensor:
    """Full SC-score matrix (q, n) int32 from the packed collision table
    ``bits`` and the (N_s, n) cell ids."""
    if not _use_kernel(impl, bits):
        return scscore_plain(bits, cells, q=q)
    return scscore_cuda(bits.contiguous(), cells.contiguous(), q=q)


def masked_rerank(bits, cells, thresh, data, data_norms, queries, k: int,
                  impl: str = "auto", precision: str = "f32"):
    """Masked re-rank: ((Q, k) ids int32, (Q, k) exact sq dists f32).

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
        bd, bi = masked_rerank_cuda(bits.contiguous(), cells.contiguous(), thresh,
                                    q_op, x_op, norms, k)
    else:
        bd, bi = masked_rerank_plain(bits, cells, thresh, q_op, x_op, norms, k)
    return finalize_topk(bd, bi, data, queries, k)


def flash_attention(q, k, v, causal: bool = True, impl: str = "auto") -> torch.Tensor:
    """Fused softmax attention (BH, S, hd) in q's dtype; the (S, T) scores
    never reach device memory. The kernel masks ragged S and T itself, so
    they are never padded."""
    if not _use_kernel(impl, q):
        return flash_attention_plain(q, k, v, causal)
    return flash_attention_cuda(q.contiguous(), k.contiguous(), v.contiguous(), causal)
