"""Masked re-rank (pass 2 of the masked-full query): the CUDA kernel
(``csrc/masked_rerank.cu``), its plain version, and :func:`finalize_topk`.

Both return the per-query k best ``(distance, id)`` pairs over the points
with ``SC >= thresh[q]``, sorted ascending on that compound key (lowest id
first on equal distances), with ``(+inf, -1)`` in the slots that no point
fills. :func:`finalize_topk` then canonicalizes the order and recomputes the
returned distances exactly from the original vectors, as in ``repro``.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import cuda
from repro_torch.kernels.schist import block_sc, unpack_collision_bits

_ARGS = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 10 + [ctypes.c_void_p]
MAX_K = 1024
MAX_SUBSPACES = 16
MAX_SMEM = 232448
#: points per chunk of pass a before the chunk count is capped
CHUNK = 4096
#: cap on partial entries per query (n_chunks * warps * k) that pass b merges
MAX_PARTIAL = 8192
#: shared memory pass a aims a block at, so that a few blocks share an SM
SMEM_TARGET = 100 * 1024


def masked_rerank_plain(bits, cells, thresh, queries, data, data_norms, k: int,
                        *, block: int = 4096):
    """Running top-k over point blocks (``repro``'s masked_rerank_stream):
    ((Q, k) dists, (Q, k) ids), no (Q, n) intermediate."""
    q = queries.shape[0]
    n = cells.shape[1]
    table = unpack_collision_bits(bits, q)
    q_norms = torch.sum(queries * queries, dim=1)
    best_d = torch.full((q, k), torch.inf, dtype=torch.float32, device=data.device)
    best_i = torch.full((q, k), -1, dtype=torch.int32, device=data.device)
    for lo in range(0, n, block):
        hi = min(n, lo + block)
        sc = block_sc(table, cells[:, lo:hi])
        dist = torch.clamp_min(
            q_norms[:, None] - 2.0 * (queries @ data[lo:hi].T) + data_norms[None, lo:hi], 0.0)
        dist = torch.where(sc >= thresh[:, None], dist, torch.inf)
        ids = torch.arange(lo, hi, dtype=torch.int32, device=data.device)
        cmb_d = torch.cat([best_d, dist], dim=1)
        cmb_i = torch.cat([best_i, ids.expand(q, -1)], dim=1)
        vals, pos = torch.sort(cmb_d, dim=1, stable=True)
        best_d = vals[:, :k]
        best_i = torch.gather(cmb_i, 1, pos[:, :k])
    return best_d, best_i


def rerank_chunks(n: int, k: int, warps: int) -> int:
    """Point chunks of pass a: one per CHUNK points, capped so the partial
    lists (one per chunk and warp) hold at most MAX_PARTIAL entries per
    query."""
    return max(1, min(math.ceil(n / CHUNK), MAX_PARTIAL // (k * warps)))


def masked_rerank_cuda(bits, cells, thresh, queries, data, data_norms, k: int):
    """Kernel launch (pass a, then pass b, on the current stream). The
    collision table of one 32-query tile plus 1-4 warps' top-k states
    must fit in a block's shared memory."""
    cuda.check_cuda(
        "masked_rerank", bits, cells, thresh, queries, data, data_norms,
        dtypes=(torch.int32, torch.int32, torch.int32, torch.float32,
                torch.float32, torch.float32))
    qt, n_sub, k2 = bits.shape
    q, d = queries.shape
    n = data.shape[0]
    if (cells.shape != (n_sub, n) or data.shape[1] != d or thresh.shape != (q,)
            or data_norms.shape != (n,) or qt != (q + 31) // 32):
        raise ValueError("masked_rerank: input shapes disagree")
    if not 0 < k <= MAX_K:
        raise ValueError(f"masked_rerank: the kernel supports 0 < k <= {MAX_K}, got {k}")
    if n_sub > MAX_SUBSPACES:
        raise ValueError(f"masked_rerank: at most {MAX_SUBSPACES} subspaces, got {n_sub}")
    lanes = 32 if k <= 512 else 16
    table, state = n_sub * k2 * 4, k * lanes * 8
    if table + state > MAX_SMEM:
        raise ValueError("masked_rerank: collision table and top-k state exceed shared memory")
    warps = max(1, min(4, (SMEM_TARGET - table) // state))
    n_chunks = rerank_chunks(n, k, warps)
    chunk = max(1, math.ceil(n / n_chunks))
    part_d = torch.empty((q, n_chunks * warps, k), dtype=torch.float32, device=data.device)
    part_i = torch.empty((q, n_chunks * warps, k), dtype=torch.int32, device=data.device)
    best_d = torch.empty((q, k), dtype=torch.float32, device=data.device)
    best_i = torch.empty((q, k), dtype=torch.int32, device=data.device)
    cuda.launch(
        "masked_rerank", "masked_rerank_f32", _ARGS,
        *(cuda.ptr(t) for t in (bits, cells, thresh, queries, data, data_norms,
                                part_d, part_i, best_d, best_i)),
        q, n, d, n_sub, k2, k, chunk, n_chunks, lanes, warps, cuda.stream(data.device))
    return best_d, best_i


def finalize_topk(best_d, best_i, data, queries, k: int):
    """Canonicalize + exactify a top-k state: order the k slots
    distance-major / id-minor (two stable argsorts), map empty slots to
    id -1, recompute the squared distances from the original vectors."""
    best_d = best_d[:, :k]
    best_i = best_i[:, :k]
    o1 = torch.argsort(best_i, dim=1, stable=True)
    d1 = torch.gather(best_d, 1, o1)
    i1 = torch.gather(best_i, 1, o1)
    o2 = torch.argsort(d1, dim=1, stable=True)
    ids = torch.gather(i1, 1, o2)
    filled = torch.isfinite(torch.gather(d1, 1, o2))
    ids = torch.where(filled, ids, -1)
    vecs = data[ids.clamp_min(0).long()]  # (Q, k, d)
    diff = vecs - queries[:, None, :]
    dists = torch.where(ids >= 0, torch.sum(diff * diff, dim=-1), torch.inf)
    return ids, dists
