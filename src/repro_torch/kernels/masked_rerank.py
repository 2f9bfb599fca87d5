"""Masked re-rank (pass 2 of the masked-full query): the CUDA kernel
(``csrc/masked_rerank.cu``), its plain version, and :func:`finalize_topk`.

Both return the per-query k best ``(distance, id)`` pairs over the points
with ``SC >= thresh[q]``, sorted ascending on that compound key (lowest id
first on equal distances), with ``(+inf, -1)`` in the slots that no point
fills. An optional exclusion bitmap (:func:`pack_exclusion`: a mutable
index's tombstones) removes points from that set. :func:`finalize_topk` then canonicalizes the order and recomputes the
returned distances exactly from the original vectors, as in ``repro``.
"""
from __future__ import annotations

import ctypes
import math
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.kernels import cuda
from repro_torch.kernels.schist import block_sc, unpack_collision_bits

_ARGS = [ctypes.c_void_p] * 12 + [ctypes.c_int] * 11 + [ctypes.c_void_p]
MAX_SMEM = 232448
#: points per chunk of pass a before the chunk count is capped (the default bn)
CHUNK = 4096
#: (bq, bn) without a tuned entry: 32 queries a block (16 above k = 512),
#: CHUNK points a chunk
DEFAULT_BLOCKS = (32, CHUNK)
#: most chunks of pass a (its grid's y extent)
MAX_CHUNKS = 65535
#: pass b's merge budget: partial entries per query (n_chunks * k) where
#: that leaves two chunks or more; a larger k takes one chunk of k entries
MAX_PARTIAL = 8192
#: warps of a block of pass a (its ``__launch_bounds__``)
WARPS = 8
#: shared memory of one warp's ring of 64 (point, query) pairs
RING_BYTES = 64 * 8


def pack_exclusion(excluded) -> torch.Tensor:
    """A (n,) bool mask (numpy or tensor) as the kernels' exclusion bitmap:
    (ceil(n/32),) int32 words, bit ``p % 32`` of word ``p // 32`` set for
    an excluded point ``p``. Packed on the host, as a tensor on the CPU."""
    mask = np.asarray(excluded.cpu() if torch.is_tensor(excluded) else excluded, bool)
    packed = np.packbits(mask, bitorder="little")
    packed = np.pad(packed, (0, -packed.size % 4))
    return torch.from_numpy(packed.view("<i4").copy())


def unpack_exclusion(words: torch.Tensor, n: int) -> torch.Tensor:
    """The (n,) bool mask of a :func:`pack_exclusion` bitmap."""
    shifts = torch.arange(32, dtype=torch.int32, device=words.device)
    return ((words[:, None] >> shifts) & 1).reshape(-1)[:n].bool()


def masked_rerank_plain(bits, cells, thresh, queries, data, data_norms, k: int,
                        exclude=None, *, block: int = 4096):
    """Running top-k over point blocks (``repro``'s masked_rerank_stream):
    ((Q, k) dists, (Q, k) ids), no (Q, n) intermediate. ``exclude`` is a
    :func:`pack_exclusion` bitmap of points that never pass, or None."""
    q = queries.shape[0]
    n = cells.shape[1]
    table = unpack_collision_bits(bits, q)
    keep = None if exclude is None else ~unpack_exclusion(exclude, n)
    q_norms = torch.sum(queries * queries, dim=1)
    best_d = torch.full((q, k), torch.inf, dtype=torch.float32, device=data.device)
    best_i = torch.full((q, k), -1, dtype=torch.int32, device=data.device)
    for lo in range(0, n, block):
        hi = min(n, lo + block)
        sc = block_sc(table, cells[:, lo:hi])
        dist = torch.clamp_min(
            q_norms[:, None] - 2.0 * (queries @ data[lo:hi].T) + data_norms[None, lo:hi], 0.0)
        mask = sc >= thresh[:, None]
        if keep is not None:
            mask &= keep[None, lo:hi]
        dist = torch.where(mask, dist, torch.inf)
        ids = torch.arange(lo, hi, dtype=torch.int32, device=data.device)
        cmb_d = torch.cat([best_d, dist], dim=1)
        cmb_i = torch.cat([best_i, ids.expand(q, -1)], dim=1)
        vals, pos = torch.sort(cmb_d, dim=1, stable=True)
        best_d = vals[:, :k]
        best_i = torch.gather(cmb_i, 1, pos[:, :k])
    return best_d, best_i


class RerankGeometry(NamedTuple):
    """A launch of ``csrc/masked_rerank.cu``'s pass a: queries a block
    (lanes), warps, points a chunk, chunks, shared memory bytes, and where
    the collision table and the top-k heaps live (``"shared"`` or
    ``"global"``)."""

    lanes: int
    warps: int
    chunk: int
    n_chunks: int
    smem: int
    table: str
    heaps: str


def rerank_geometry(n: int, k: int, n_sub: int, k2: int, d: int, blocks=None) -> RerankGeometry:
    """Launch geometry of pass a, as ``csrc/masked_rerank.cu`` lays out
    shared memory.

    A block takes ``lanes`` queries and ``chunk`` points. ``blocks = (bq,
    bn)`` (default :data:`DEFAULT_BLOCKS`) asks for ``bq`` lanes (32, or
    16 below 32) and chunks of ``bn`` points; lanes are 16 above k = 512
    whatever is asked, and above k = 1024 they halve (down to 1) until the
    heaps (k x lanes entries of 8 bytes) fit in shared memory with one
    warp's ring; past that (k above ~28,900) the heaps live in global
    memory at 16 lanes. The block's ``warps`` share one top-k state and each
    has its own ring. Shared memory: the heaps where they fit, the rings,
    |q|^2 and the locks (256 bytes), the collision table (N_s x k2 words)
    where it still fits with one ring, else the table is read from global
    memory, and, where they still fit, the query rows at a stride of d + 4
    floats (d + 1 if d % 4). The chunk count is capped so that pass b's
    lists hold at most MAX_PARTIAL entries per query (one chunk where k is
    larger), and at MAX_CHUNKS. Raises only for k < 1 or N_s < 1."""
    if k < 1:
        raise ValueError(f"masked_rerank: k must be positive, got {k}")
    if n_sub < 1:
        raise ValueError(f"masked_rerank: N_s must be positive, got {n_sub}")
    bq, bn = DEFAULT_BLOCKS if blocks is None else (int(blocks[0]), int(blocks[1]))
    lanes = 32 if k <= 512 and bq >= 32 else 16
    rest = 256 + RING_BYTES  # |q|^2, the locks and one ring
    while lanes > 1 and k * lanes * 8 + rest > MAX_SMEM:
        lanes //= 2
    heaps = k * lanes * 8
    if heaps + rest > MAX_SMEM:
        lanes, heaps = 16, 0
    table = n_sub * k2 * 4
    if heaps + table + rest > MAX_SMEM:
        table = 0
    base = heaps + table + 256
    warps = min(WARPS, (MAX_SMEM - base) // RING_BYTES)
    smem = base + warps * RING_BYTES
    rows = lanes * (d + 4 if d % 4 == 0 else d + 1) * 4
    if smem + rows <= MAX_SMEM:
        smem += rows
    n_chunks = max(1, min(math.ceil(n / max(bn, 1)), MAX_PARTIAL // k, MAX_CHUNKS))
    chunk = max(1, math.ceil(n / n_chunks))
    return RerankGeometry(lanes, warps, chunk, n_chunks, smem,
                          "shared" if table else "global", "shared" if heaps else "global")


def rerank_resident_warps(n: int, k: int, n_sub: int, k2: int, d: int) -> int:
    """Warps of pass a resident on one SM at this geometry (the CUDA
    occupancy calculator; needs the card)."""
    g = rerank_geometry(n, k, n_sub, k2, d)
    blocks = ctypes.c_int(0)
    fn = cuda.library("masked_rerank").masked_rerank_occupancy
    fn.argtypes = [ctypes.c_int] * 8 + [ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    if fn(d, n_sub, k2, k, g.lanes, g.warps, int(g.table == "shared"),
          int(g.heaps == "shared"), ctypes.byref(blocks)) != 0:
        raise RuntimeError("masked_rerank: occupancy query failed")
    return blocks.value * g.warps


def masked_rerank_cuda(bits, cells, thresh, queries, data, data_norms, k: int,
                       exclude=None, blocks=None):
    """Kernel launch (pass a, then pass b, on the current stream), at
    :func:`rerank_geometry`'s geometry for ``blocks = (bq, bn)`` (default
    :data:`DEFAULT_BLOCKS`; :data:`cuda.launch_blocks` keeps the launch's,
    and :data:`cuda.launch_layouts` counts it under ``table=<place>,
    heaps=<place>``). Any k >= 1 and N_s >= 1. ``exclude`` is a
    :func:`pack_exclusion` bitmap on the card, or None (a null pointer: the
    kernel reads no bitmap)."""
    cuda.check_cuda(
        "masked_rerank", bits, cells, thresh, queries, data, data_norms,
        *(() if exclude is None else (exclude,)),
        dtypes=(torch.int32, torch.int32, torch.int32, torch.float32,
                torch.float32, torch.float32, torch.int32))
    qt, n_sub, k2 = bits.shape
    q, d = queries.shape
    n = data.shape[0]
    if (cells.shape != (n_sub, n) or data.shape[1] != d or thresh.shape != (q,)
            or data_norms.shape != (n,) or qt != (q + 31) // 32
            or (exclude is not None and exclude.shape != ((n + 31) // 32,))):
        raise ValueError("masked_rerank: input shapes disagree")
    blocks = DEFAULT_BLOCKS if blocks is None else (int(blocks[0]), int(blocks[1]))
    g = rerank_geometry(n, k, n_sub, k2, d, blocks)
    part_d = torch.empty((q, g.n_chunks, k), dtype=torch.float32, device=data.device)
    part_i = torch.empty((q, g.n_chunks, k), dtype=torch.int32, device=data.device)
    best_d = torch.empty((q, k), dtype=torch.float32, device=data.device)
    best_i = torch.empty((q, k), dtype=torch.int32, device=data.device)
    heap = None  # the heaps' scratch where they live in global memory: 8-byte entries
    if g.heaps == "global":
        heap = torch.empty((q, g.n_chunks, k), dtype=torch.int64, device=data.device)
    cuda.launch(
        "masked_rerank", "masked_rerank_f32", _ARGS,
        *(cuda.ptr(t) for t in (bits, cells, thresh, queries, data, data_norms)),
        ctypes.c_void_p(None) if exclude is None else cuda.ptr(exclude),
        *(cuda.ptr(t) for t in (part_d, part_i, best_d, best_i)),
        ctypes.c_void_p(None) if heap is None else cuda.ptr(heap),
        q, n, d, n_sub, k2, k, g.chunk, g.n_chunks, g.lanes, g.warps,
        int(g.table == "shared"), cuda.stream(data.device), blocks=blocks,
        layout=f"table={g.table},heaps={g.heaps}")
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
