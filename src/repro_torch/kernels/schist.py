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
from typing import NamedTuple

import torch

from repro_torch.kernels import cuda

_ARGS = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 10 + [ctypes.c_void_p]
#: the most subspaces a histogram takes: N_s + 1 <= 128 levels, the
#: reference's bound (``schist_pallas``'s ``n_levels <= 128``)
MAX_SUBSPACES = 127
#: the fast kernel's most subspaces (``kMaxSub`` in csrc/collision.cuh)
FAST_SUBSPACES = 16
MAX_SMEM = 232448
#: points per work item of the kernel's persistent grid (the default bn)
CHUNK = 2048
#: largest work item a cached bn may ask for (a multiple of every warp step)
MAX_CHUNK = 1 << 20
#: (bq, bn) without a tuned entry: up to 8 tiles of 32 queries a block,
#: CHUNK points a work item
DEFAULT_BLOCKS = (256, CHUNK)
#: per-lane count registers (tiles x levels) a block may hold
MAX_COUNTERS = 64
#: depth of each warp's cell-id ring (``kStages`` in csrc/schist.cu)
STAGES = 3
#: the wide kernel's fewest points a block (its counts are flushed to the
#: output once a block)
WIDE_CHUNK = 16384


class SchistGeometry(NamedTuple):
    """A launch of ``csrc/schist.cu``: query tiles a block, warps, shared
    memory bytes, query tile groups, where a tile's collision table lives
    (``"shared"`` or ``"global"``) and whether the wide kernel runs."""

    tiles: int
    warps: int
    smem: int
    groups: int
    table: str
    wide: bool


def schist_geometry(q: int, n_sub: int, k2: int, blocks=None) -> SchistGeometry:
    """Launch geometry of the kernel. Up to :data:`FAST_SUBSPACES`
    subspaces, where one tile's table fits with its counts, the fast kernel:
    T is the most tiles (a power of two, at most 8 and at most ``bq // 32``
    of the optional ``blocks = (bq, bn)``, no more than the batch has) whose
    tables, count registers, per-block counts and cell-id rings fit; warps
    shrink from 8 before T does. Without blocks they are
    :data:`DEFAULT_BLOCKS`. Every other shape up to :data:`MAX_SUBSPACES`
    takes the wide kernel: one tile a block, 8 warps, the (N_s + 1, 32)
    counts and, where it fits beside them, the table in shared memory, else
    the table in global memory. Raises only for N_s outside 1 to 127, as
    the reference does."""
    if not 1 <= n_sub <= MAX_SUBSPACES:
        raise ValueError(f"schist: 1 to {MAX_SUBSPACES} subspaces, got {n_sub}")
    qt = (q + 31) // 32
    if n_sub > FAST_SUBSPACES or (n_sub * k2 + 4 * (n_sub + 1) * 32) * 4 > MAX_SMEM:
        counts = (n_sub + 1) * 32 * 4
        table_in = counts + n_sub * k2 * 4 <= MAX_SMEM
        return SchistGeometry(1, 8, counts + (n_sub * k2 * 4 if table_in else 0), qt,
                              "shared" if table_in else "global", True)
    levels = min(1 << n_sub.bit_length(), FAST_SUBSPACES + 1)  # count registers a tile
    bq = DEFAULT_BLOCKS[0] if blocks is None else int(blocks[0])
    for tiles in (8, 4, 2, 1):
        if tiles > 1 and (32 * tiles > bq or tiles >= 2 * qt or tiles * levels > MAX_COUNTERS):
            continue
        for warps in (8, 4, 2, 1):
            smem = 4 * (n_sub * (k2 + 1) * tiles + tiles * (n_sub + 1) * 32
                        + warps * STAGES * n_sub * 32)
            if smem <= MAX_SMEM:
                return SchistGeometry(tiles, warps, smem, -(-qt // tiles), "shared", False)
    raise AssertionError("unreachable: one tile with one warp always fits")


def schist_chunk(warps: int, blocks=None, wide: bool = False) -> int:
    """Points a work item of the persistent grid (or, for the ``wide``
    kernel, a block: at least :data:`WIDE_CHUNK`): ``bn`` of the optional
    ``blocks = (bq, bn)`` (default :data:`DEFAULT_BLOCKS`) rounded up to
    whole warp steps of the block (32 points a warp), at most
    :data:`MAX_CHUNK`."""
    bn = DEFAULT_BLOCKS[1] if blocks is None else int(blocks[1])
    if wide:
        bn = max(bn, WIDE_CHUNK)
    step = 32 * warps
    return min(max(-(-bn // step), 1) * step, MAX_CHUNK)


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


def schist_cuda(bits, cells, n_levels: int, *, q: int, blocks=None) -> torch.Tensor:
    """Kernel launch: (q, n_levels) int32 histogram; n_levels = N_s + 1,
    N_s from 1 to 127 and any K. ``blocks = (bq, bn)`` (default
    :data:`DEFAULT_BLOCKS`) sets the queries a block and the points a work
    item, as :func:`schist_geometry` and :func:`schist_chunk` clamp them;
    :data:`cuda.launch_blocks` keeps the launch's, and
    :data:`cuda.launch_layouts` counts it under ``table=<place>``."""
    cuda.check_cuda("schist", bits, cells, dtypes=(torch.int32, torch.int32))
    qt, n_sub, k2 = bits.shape
    n = cells.shape[1]
    if cells.shape[0] != n_sub or n_levels != n_sub + 1 or qt != (q + 31) // 32:
        raise ValueError(
            f"schist: bits {tuple(bits.shape)}, cells {tuple(cells.shape)}, "
            f"n_levels {n_levels}, q {q} disagree")
    blocks = DEFAULT_BLOCKS if blocks is None else (int(blocks[0]), int(blocks[1]))
    g = schist_geometry(q, n_sub, k2, blocks)
    out = torch.empty((q, n_levels), dtype=torch.int32, device=bits.device)
    cuda.launch("schist", "schist_i32", _ARGS, cuda.ptr(bits), cuda.ptr(cells),
                cuda.ptr(out), q, n, n_sub, k2, g.tiles, g.warps,
                schist_chunk(g.warps, blocks, g.wide), g.smem, int(g.wide),
                int(g.table == "shared"), cuda.stream(bits.device), blocks=blocks,
                layout=f"table={g.table}")
    return out
