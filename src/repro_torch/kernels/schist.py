"""SC-score histogram (pass 1 of the masked-full query): the CUDA kernel
(``csrc/schist.cu``), its plain version, and the collision table both
passes read.

The collision table holds, per (subspace, query, IMI cell), whether the
cell's distance sum ``d1[c1] + d2[c2]`` is within the query's activation
threshold. It is built once per query batch and packed with the query axis
in the bits (:func:`collision_bits`): word ``[t, s, c]`` holds the bits of
queries ``32 t .. 32 t + 31``. Both the kernel and the plain version take
that packed table and the per-index cell ids (:func:`cell_ids`).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import cuda

_ARGS = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
MAX_SUBSPACES = 16
MAX_SMEM = 232448
#: points per work item of the kernel's persistent grid
CHUNK = 2048
#: per-lane count registers (tiles x levels) a block may hold
MAX_COUNTERS = 64
#: depth of each warp's cell-id ring (``kStages`` in csrc/schist.cu)
STAGES = 3


def schist_geometry(q: int, n_sub: int, k2: int):
    """Launch geometry of the kernel: (tiles T, warps, smem bytes, query
    tile groups). T is the most tiles (a power of two, at most 8, no more
    than the batch has) whose tables, count registers, per-block counts and
    cell-id rings fit; warps shrink from 8 before T does. Raises only where
    one tile's table does not fit, as the kernel always has."""
    if not 1 <= n_sub <= MAX_SUBSPACES:
        raise ValueError(f"schist: 1 to {MAX_SUBSPACES} subspaces, got {n_sub}")
    if (n_sub * k2 + 4 * (n_sub + 1) * 32) * 4 > MAX_SMEM:
        raise ValueError(f"schist: a {n_sub} x {k2} collision table exceeds shared memory")
    qt = (q + 31) // 32
    levels = min(1 << n_sub.bit_length(), MAX_SUBSPACES + 1)  # count registers a tile
    for tiles in (8, 4, 2, 1):
        if tiles > 1 and (tiles >= 2 * qt or tiles * levels > MAX_COUNTERS):
            continue
        for warps in (8, 4, 2, 1):
            smem = 4 * (n_sub * (k2 + 1) * tiles + tiles * (n_sub + 1) * 32
                        + warps * STAGES * n_sub * 32)
            if smem <= MAX_SMEM:
                return tiles, warps, smem, -(-qt // tiles)
    raise AssertionError("unreachable: one tile with one warp always fits")


def collision_table(d1s, d2s, taus) -> torch.Tensor:
    """Per-(subspace, query, IMI cell) collision flags: (N_s, Q, sqrt_k^2)
    bool; the compared sum ``d1[c1] + d2[c2]`` is the same two floats as
    the per-point test."""
    n_sub, q, sqrt_k = d1s.shape
    table = (d1s[:, :, :, None] + d2s[:, :, None, :]) <= taus[:, :, None, None]
    return table.reshape(n_sub, q, sqrt_k * sqrt_k)


def collision_bits(table: torch.Tensor) -> torch.Tensor:
    """Pack a (N_s, Q, K2) table into (ceil(Q/32), N_s, K2) int32 words with
    query ``32 t + j`` in bit j of word ``[t, s, c]``."""
    n_sub, q, k2 = table.shape
    qt = (q + 31) // 32
    padded = torch.zeros((n_sub, qt * 32, k2), dtype=torch.int64, device=table.device)
    padded[:, :q] = table.to(torch.int64)
    weights = torch.ones(32, dtype=torch.int64, device=table.device) << torch.arange(
        32, dtype=torch.int64, device=table.device)
    words = (padded.view(n_sub, qt, 32, k2).permute(1, 0, 3, 2) * weights).sum(-1)
    words = torch.where(words >= 2**31, words - 2**32, words)
    return words.to(torch.int32).contiguous()


def unpack_collision_bits(bits: torch.Tensor, q: int) -> torch.Tensor:
    """Inverse of :func:`collision_bits`: (N_s, q, K2) bool."""
    qt, n_sub, k2 = bits.shape
    shifts = torch.arange(32, dtype=torch.int32, device=bits.device)
    flags = (bits[..., None] >> shifts) & 1  # (qt, n_sub, k2, 32)
    return flags.permute(1, 0, 3, 2).reshape(n_sub, qt * 32, k2)[:, :q].bool()


def cell_ids(a1s, a2s, sqrt_k: int) -> torch.Tensor:
    """Combined IMI cell index per (subspace, point): (N_s, n) int32."""
    return (a1s.to(torch.int32) * sqrt_k + a2s.to(torch.int32)).contiguous()


def block_sc(table: torch.Tensor, cells_blk: torch.Tensor) -> torch.Tensor:
    """(Q, bn) SC-scores of one point block from the unpacked table."""
    sc = torch.zeros((table.shape[1], cells_blk.shape[1]), dtype=torch.int32,
                     device=table.device)
    for s in range(table.shape[0]):
        sc += table[s][:, cells_blk[s].long()]
    return sc


def schist_plain(bits, cells, n_levels: int, *, q: int, block: int = 4096):
    """(q, n_levels) int32 per-query SC histogram, streamed over point
    blocks so no (Q, n) matrix exists (``repro``'s ``schist_stream``)."""
    table = unpack_collision_bits(bits, q)
    n = cells.shape[1]
    hist = torch.zeros((q, n_levels), dtype=torch.int32, device=bits.device)
    for lo in range(0, n, block):
        sc = block_sc(table, cells[:, lo:lo + block])
        for lvl in range(n_levels):
            hist[:, lvl] += torch.sum(sc == lvl, dim=1, dtype=torch.int32)
    return hist


def schist_cuda(bits, cells, n_levels: int, *, q: int) -> torch.Tensor:
    """Kernel launch: (q, n_levels) int32 histogram; n_levels = N_s + 1."""
    cuda.check_cuda("schist", bits, cells, dtypes=(torch.int32, torch.int32))
    qt, n_sub, k2 = bits.shape
    n = cells.shape[1]
    if cells.shape[0] != n_sub or n_levels != n_sub + 1 or qt != (q + 31) // 32:
        raise ValueError(
            f"schist: bits {tuple(bits.shape)}, cells {tuple(cells.shape)}, "
            f"n_levels {n_levels}, q {q} disagree")
    tiles, warps, smem, _groups = schist_geometry(q, n_sub, k2)
    out = torch.empty((q, n_levels), dtype=torch.int32, device=bits.device)
    cuda.launch("schist", "schist_i32", _ARGS, cuda.ptr(bits), cuda.ptr(cells),
                cuda.ptr(out), q, n, n_sub, k2, tiles, warps, CHUNK, smem,
                cuda.stream(bits.device))
    return out
