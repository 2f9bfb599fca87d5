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
#: cap on partial entries per query (n_chunks * k) that pass b merges
MAX_PARTIAL = 8192
#: warps of a block of pass a (its ``__launch_bounds__``)
WARPS = 8
#: shared memory of one warp's ring of 64 (point, query) pairs
RING_BYTES = 64 * 8


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


def rerank_geometry(n: int, k: int, n_sub: int, k2: int, d: int):
    """Launch geometry of pass a, as ``csrc/masked_rerank.cu`` lays out
    shared memory: ``(lanes, warps, chunk, n_chunks, smem_bytes)``.

    A block takes ``lanes`` queries (16 above k = 512, so the top-k state
    fits) and ``chunk`` points; its ``warps`` share one top-k state and each
    has its own ring. Shared memory: the heaps (k x lanes entries of 8
    bytes), the rings, |q|^2 and the locks (256 bytes), the collision table
    (N_s x k2 words) and, where they still fit, the query rows at a stride
    of d + 4 floats (d + 1 if d % 4). The chunk count is capped so the
    partial lists hold at most MAX_PARTIAL entries per query."""
    if not 0 < k <= MAX_K:
        raise ValueError(f"masked_rerank: the kernel supports 0 < k <= {MAX_K}, got {k}")
    if n_sub > MAX_SUBSPACES:
        raise ValueError(f"masked_rerank: at most {MAX_SUBSPACES} subspaces, got {n_sub}")
    lanes = 32 if k <= 512 else 16
    base = n_sub * k2 * 4 + k * lanes * 8 + 256
    warps = min(WARPS, (MAX_SMEM - base) // RING_BYTES)
    if warps < 1:
        raise ValueError("masked_rerank: collision table and top-k state exceed shared memory")
    smem = base + warps * RING_BYTES
    rows = lanes * (d + 4 if d % 4 == 0 else d + 1) * 4
    if smem + rows <= MAX_SMEM:
        smem += rows
    n_chunks = max(1, min(math.ceil(n / CHUNK), MAX_PARTIAL // k))
    chunk = max(1, math.ceil(n / n_chunks))
    return lanes, warps, chunk, n_chunks, smem


def rerank_resident_warps(n: int, k: int, n_sub: int, k2: int, d: int) -> int:
    """Warps of pass a resident on one SM at this geometry (the CUDA
    occupancy calculator; needs the card)."""
    lanes, warps, _, _, _ = rerank_geometry(n, k, n_sub, k2, d)
    blocks = ctypes.c_int(0)
    fn = cuda.library("masked_rerank").masked_rerank_occupancy
    fn.argtypes = [ctypes.c_int] * 6 + [ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    if fn(d, n_sub, k2, k, lanes, warps, ctypes.byref(blocks)) != 0:
        raise RuntimeError("masked_rerank: occupancy query failed")
    return blocks.value * warps


def masked_rerank_cuda(bits, cells, thresh, queries, data, data_norms, k: int):
    """Kernel launch (pass a, then pass b, on the current stream), at
    :func:`rerank_geometry`'s geometry."""
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
    lanes, warps, chunk, n_chunks, _ = rerank_geometry(n, k, n_sub, k2, d)
    part_d = torch.empty((q, n_chunks, k), dtype=torch.float32, device=data.device)
    part_i = torch.empty((q, n_chunks, k), dtype=torch.int32, device=data.device)
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
