"""Launch geometry of the ``schist`` kernel (``kernels/schist.py:
schist_geometry``) and its persistent walk, held on the CPU.

The geometry is a pure function of the sizes: the tiles a block holds (T),
its warps and its shared memory. The walk (which block takes which (tile
group, point chunk) work item, and which points a warp step covers) is
re-derived here with the kernel's own index arithmetic
(``csrc/schist.cu``) and run step by step in numpy, with the table
interleaved as the kernel keeps it, the carry-save planes, the bit
transposes and the per-level popcounts, to show it counts every (query,
point) pair once and equals ``schist_plain``.
"""
import numpy as np
import pytest
import torch

from repro_torch.batching import ANN_BATCH_BUCKETS
from repro_torch.kernels.autotune import CANDIDATES
from repro_torch.kernels.schist import (
    CHUNK,
    DEFAULT_BLOCKS,
    MAX_CHUNK,
    MAX_COUNTERS,
    MAX_SMEM,
    STAGES,
    WIDE_CHUNK,
    collision_bits,
    collision_table,
    schist_chunk,
    schist_geometry,
    schist_plain,
)

K2 = 1024


def _parent_geometry(q, n_sub, k2):
    """``schist_geometry`` as it was before it took blocks (the untuned
    main path's launch)."""
    qt = (q + 31) // 32
    levels = min(1 << n_sub.bit_length(), 17)
    for tiles in (8, 4, 2, 1):
        if tiles > 1 and (tiles >= 2 * qt or tiles * levels > 64):
            continue
        for warps in (8, 4, 2, 1):
            smem = 4 * (n_sub * (k2 + 1) * tiles + tiles * (n_sub + 1) * 32
                        + warps * STAGES * n_sub * 32)
            if smem <= MAX_SMEM:
                return tiles, warps, smem, -(-qt // tiles)
    raise AssertionError


def _parent_takes(n_sub, k2):
    """The shape limit of the kernel before the multi-tile design."""
    return n_sub <= 16 and (n_sub * k2 + 4 * (n_sub + 1) * 32) * 4 <= MAX_SMEM


@pytest.mark.parametrize("q", [1, 33, 37, 1000, 1024, 1025])
@pytest.mark.parametrize("n_sub", [1, 3, 6, 7, 8, 15, 16])
@pytest.mark.parametrize("k2", [25, 1024, 2048])
def test_schist_geometry(q, n_sub, k2):
    tiles, warps, smem, groups, table, wide = schist_geometry(q, n_sub, k2)
    assert table == "shared" and not wide  # the fast kernel takes these shapes
    qt = (q + 31) // 32
    assert tiles in (1, 2, 4, 8)
    # no more tiles than the batch has, rounded up to a power of two
    assert tiles == 1 or tiles < 2 * qt
    levels = min(1 << n_sub.bit_length(), 17)
    assert tiles == 1 or tiles * levels <= 64
    assert warps in (1, 2, 4, 8) and CHUNK % (warps * 32) == 0
    assert smem == 4 * (n_sub * (k2 + 1) * tiles + tiles * (n_sub + 1) * 32
                        + warps * STAGES * n_sub * 32)
    assert smem <= MAX_SMEM
    assert groups * tiles >= qt and (groups - 1) * tiles < qt


@pytest.mark.parametrize("n_sub", [1, 3, 6, 7, 8, 15, 16])
@pytest.mark.parametrize("k2", [25, 1024, 2048])
def test_schist_geometry_without_blocks_is_the_parents(n_sub, k2):
    """No blocks, or the default ones: the geometry and the work item the
    kernel had before the cache, so the untuned path launches as it did."""
    for q in (1, 33, 64, 100, 1000, 1024, 1025):
        want = _parent_geometry(q, n_sub, k2)
        assert schist_geometry(q, n_sub, k2)[:4] == want
        assert schist_geometry(q, n_sub, k2, DEFAULT_BLOCKS)[:4] == want
        assert schist_geometry(q, n_sub, k2)[4:] == ("shared", False)
        assert schist_chunk(want[1]) == schist_chunk(want[1], DEFAULT_BLOCKS) == CHUNK


@pytest.mark.parametrize("blocks", CANDIDATES["schist"])
@pytest.mark.parametrize("n_sub,k2", [(6, 1024), (16, 2048), (3, 25)])
def test_schist_candidates_give_legal_launches(blocks, n_sub, k2):
    """Every candidate at the main path's batch and at every engine bucket
    gives what ``csrc/schist.cu`` accepts: 1, 2, 4 or 8 tiles, no more than
    bq asks, that the batch fills and the count registers hold; a chunk of
    whole warp steps; the shared memory the launch sets."""
    levels = min(1 << n_sub.bit_length(), 17)
    for q in sorted({1000, *ANN_BATCH_BUCKETS}):
        tiles, warps, smem, groups, *_ = schist_geometry(q, n_sub, k2, blocks)
        qt = (q + 31) // 32
        assert tiles in (1, 2, 4, 8) and 32 * tiles <= max(blocks[0], 32)
        # the kernel's (tiles, planes) instantiations: T x levels <= 64
        assert tiles == 1 or (tiles < 2 * qt and tiles * levels <= MAX_COUNTERS)
        assert warps in (1, 2, 4, 8) and smem <= MAX_SMEM
        assert groups * tiles >= qt and (groups - 1) * tiles < qt
        chunk = schist_chunk(warps, blocks)
        assert chunk % (32 * warps) == 0 and blocks[1] <= chunk < blocks[1] + 32 * warps
        assert chunk <= MAX_CHUNK
        # at the main path's batch the candidates' tiles are what they ask for
        if q >= 1000 and n_sub == 6:
            assert 32 * tiles == blocks[0]


def test_schist_blocks_clamp():
    """Blocks outside the grid clamp: bq below a tile gives one tile, a bn
    that is no whole number of warp steps rounds up, a huge one stops at
    MAX_CHUNK."""
    assert schist_geometry(1000, 6, K2, (8, 512))[0] == 1
    assert schist_geometry(1000, 6, K2, (100, 512))[0] == 2
    assert schist_geometry(1000, 6, K2, (4096, 512))[0] == 8
    assert schist_chunk(8, (256, 1000)) == 1024
    assert schist_chunk(8, (256, 1)) == 256
    assert schist_chunk(4, (256, 1 << 40)) == MAX_CHUNK


def test_schist_geometry_main_path():
    """Q 1000 (or its 1024 bucket), N_s 6, K 1024: eight tiles, 8 warps,
    four tile groups; N_s 16 at K 2048 holds one tile."""
    for q in (1000, 1024):
        assert schist_geometry(q, 6, K2) == (8, 8, 222400, 4, "shared", False)
    assert schist_geometry(1000, 16, 2048)[0] == 1
    assert schist_geometry(37, 6, K2)[:2] == (2, 8)


@pytest.mark.parametrize("n_sub", [1, 2, 6, 11, 16])
def test_schist_geometry_refuses_nothing_new(n_sub):
    """Every table the fast kernel took before still fits it, with fewer
    warps where it must; the first one past it, once refused, now takes the
    wide kernel, and so does a table past shared memory, from global
    memory."""
    k2 = max(k for k in range(1, 60000) if _parent_takes(n_sub, k))
    for q in (1, 1000):
        tiles, warps, smem, _g, table, wide = schist_geometry(q, n_sub, k2)
        assert tiles == 1 and smem <= MAX_SMEM and table == "shared" and not wide
    for k2_past in (k2 + 1, 4 * k2):
        _wide_layout(schist_geometry(1000, n_sub, k2_past), 1000, n_sub, k2_past)
    assert schist_geometry(1000, n_sub, 4 * k2).table == "global"


def _wide_layout(g, q, n_sub, k2):
    """What ``schist_i32`` accepts for the wide kernel: one tile, 8 warps,
    the (N_s + 1, 32) counts and the table where it is staged, within the
    block's shared memory; one work item a block of whole warp steps."""
    counts = (n_sub + 1) * 32 * 4
    assert g.wide and g.tiles == 1 and g.warps == 8 and g.groups == (q + 31) // 32
    assert g.smem == counts + (n_sub * k2 * 4 if g.table == "shared" else 0) <= MAX_SMEM
    assert g.table == ("shared" if counts + n_sub * k2 * 4 <= MAX_SMEM else "global")
    chunk = schist_chunk(g.warps, DEFAULT_BLOCKS, g.wide)
    assert chunk % (32 * g.warps) == 0 and chunk >= WIDE_CHUNK


def test_schist_geometry_rejects():
    """What the reference rejects (N_s = 0, and N_s + 1 > 128 levels) is
    refused; past 16 subspaces, up to 127, and at tables past shared memory
    the wide kernel takes the shape."""
    with pytest.raises(ValueError):
        schist_geometry(100, 0, K2)
    with pytest.raises(ValueError):
        schist_geometry(100, 128, K2)
    for n_sub, k2 in ((17, K2), (20, K2), (127, K2), (127, 64), (20, 4096), (6, 16384)):
        for q in (1, 100, 1000):
            _wide_layout(schist_geometry(q, n_sub, k2), q, n_sub, k2)
    assert schist_geometry(1000, 20, 4096).table == "global"  # 320 KB a tile
    assert schist_geometry(1000, 127, K2).table == "global"
    assert schist_geometry(1000, 17, K2).table == "shared"


def _transpose(words):
    """(..., 32) words, lane i's bit j -> lane j's bit i."""
    bits = (words[..., :, None] >> np.arange(32, dtype=np.uint64)) & 1  # (..., lane, bit)
    return (np.swapaxes(bits, -1, -2) << np.arange(32, dtype=np.uint64)).sum(-1)


def _emulate(bits, cells, q, grid, blocks=None):
    """The kernel's walk and count, block by block and step by step, at the
    geometry of ``blocks``."""
    qt, n_sub, k2 = bits.shape
    n = cells.shape[1]
    tiles, warps, _smem, groups, *_ = schist_geometry(q, n_sub, k2, blocks)
    chunk = schist_chunk(warps, blocks)
    n_planes = n_sub.bit_length()
    row = k2 + 1
    words = bits.astype(np.uint32).astype(np.uint64)
    n_chunks = -(-n // chunk)
    n_items = n_chunks * groups
    grid = min(grid, n_items)
    steps = chunk // (warps * 32)
    out = np.zeros((q, n_sub + 1), np.int64)
    seen = np.zeros((groups, n), np.int64)
    for blk in range(grid):
        i0, i1 = blk * n_items // grid, (blk + 1) * n_items // grid
        for k in range((i1 - i0) * steps):
            item = i0 + k // steps
            g = item // n_chunks
            tab = np.zeros((n_sub, row, tiles), np.uint64)
            for t in range(tiles):
                if g * tiles + t < qt:
                    tab[:, :k2, t] = words[g * tiles + t]
            for warp in range(warps):
                base = (item % n_chunks) * chunk + ((k % steps) * warps + warp) * 32
                if base >= n:
                    continue
                p = base + np.arange(32)
                valid = p < n
                seen[g, p[valid]] += 1
                cell = np.where(valid, cells[:, np.minimum(p, n - 1)], k2)  # (n_sub, 32)
                sc = tab[np.arange(n_sub)[:, None], cell]  # (n_sub, lane, tiles)
                planes = np.zeros((n_planes, 32, tiles), np.uint64)
                for s in range(0, n_sub, 2):
                    a = sc[s]
                    b = sc[s + 1] if s + 1 < n_sub else np.zeros_like(a)
                    carry = (planes[0] & a) | (planes[0] & b) | (a & b)
                    planes[0] ^= a ^ b
                    for j in range(1, n_planes):
                        carry, planes[j] = planes[j] & carry, planes[j] ^ carry
                planes = _transpose(np.swapaxes(planes, 1, 2))  # (planes, tiles, lane = query)
                empty = 32 - int(valid.sum())
                for lvl in range(n_sub + 1):
                    m = np.full((tiles, 32), 0xFFFFFFFF, np.uint64)
                    for j in range(n_planes):
                        m &= planes[j] if (lvl >> j) & 1 else ~planes[j] & 0xFFFFFFFF
                    cnt = np.vectorize(lambda w: bin(int(w)).count("1"))(m)
                    if lvl == 0:
                        cnt = cnt - empty
                    qg = (g * tiles + np.arange(tiles))[:, None] * 32 + np.arange(32)
                    keep = qg < q
                    np.add.at(out[:, lvl], qg[keep], cnt[keep])
    assert (seen == 1).all()
    return out


@pytest.mark.parametrize("n_sub,q,sqrt_k,n,grid", [
    (3, 37, 5, 5000, 3), (6, 70, 8, 2100, 5), (1, 33, 4, 300, 2), (2, 130, 4, 4200, 7),
])
def test_schist_walk_emulated(n_sub, q, sqrt_k, n, grid):
    bits, cells = _walk_case(n_sub, q, sqrt_k, n)
    want = schist_plain(bits, cells, n_sub + 1, q=q)
    got = _emulate(bits.numpy(), cells.numpy(), q, grid)
    np.testing.assert_array_equal(got, want.numpy())


def _walk_case(n_sub, q, sqrt_k, n):
    rng = np.random.default_rng(n)
    d1s = torch.as_tensor(rng.uniform(0, 4, (n_sub, q, sqrt_k)).astype(np.float32))
    d2s = torch.as_tensor(rng.uniform(0, 4, (n_sub, q, sqrt_k)).astype(np.float32))
    taus = torch.as_tensor(rng.uniform(1, 5, (n_sub, q)).astype(np.float32))
    cells = torch.as_tensor(rng.integers(0, sqrt_k * sqrt_k, (n_sub, n)), dtype=torch.int32)
    return collision_bits(collision_table(d1s, d2s, taus)), cells


@pytest.mark.parametrize("blocks", CANDIDATES["schist"])
def test_schist_walk_emulated_for_every_candidate(blocks):
    """Each candidate's tiles and work items still walk every (query tile,
    point) pair once: 9 query tiles (a ragged last group at 2, 4 and 8
    tiles a block) and n past one chunk of the largest bn, over 13 blocks."""
    n_sub, q, sqrt_k, n, grid = 3, 270, 4, 8300, 13
    bits, cells = _walk_case(n_sub, q, sqrt_k, n)
    want = schist_plain(bits, cells, n_sub + 1, q=q)
    got = _emulate(bits.numpy(), cells.numpy(), q, grid, blocks)
    np.testing.assert_array_equal(got, want.numpy())
