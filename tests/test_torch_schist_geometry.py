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

from repro_torch.kernels.schist import (
    CHUNK,
    MAX_SMEM,
    STAGES,
    collision_bits,
    collision_table,
    schist_geometry,
    schist_plain,
)

K2 = 1024


def _parent_takes(n_sub, k2):
    """The shape limit of the kernel before the multi-tile design."""
    return n_sub <= 16 and (n_sub * k2 + 4 * (n_sub + 1) * 32) * 4 <= MAX_SMEM


@pytest.mark.parametrize("q", [1, 33, 37, 1000, 1024, 1025])
@pytest.mark.parametrize("n_sub", [1, 3, 6, 7, 8, 15, 16])
@pytest.mark.parametrize("k2", [25, 1024, 2048])
def test_schist_geometry(q, n_sub, k2):
    tiles, warps, smem, groups = schist_geometry(q, n_sub, k2)
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


def test_schist_geometry_main_path():
    """Q 1000 (or its 1024 bucket), N_s 6, K 1024: eight tiles, 8 warps,
    four tile groups; N_s 16 at K 2048 holds one tile."""
    for q in (1000, 1024):
        assert schist_geometry(q, 6, K2) == (8, 8, 222400, 4)
    assert schist_geometry(1000, 16, 2048)[0] == 1
    assert schist_geometry(37, 6, K2)[:2] == (2, 8)


@pytest.mark.parametrize("n_sub", [1, 2, 6, 11, 16])
def test_schist_geometry_refuses_nothing_new(n_sub):
    """Every table the kernel took before still fits, with fewer warps
    where it must; the first one past it is refused as before."""
    k2 = max(k for k in range(1, 60000) if _parent_takes(n_sub, k))
    for q in (1, 1000):
        tiles, warps, smem, _g = schist_geometry(q, n_sub, k2)
        assert tiles == 1 and smem <= MAX_SMEM
    with pytest.raises(ValueError):
        schist_geometry(1000, n_sub, k2 + 1)


def test_schist_geometry_rejects():
    with pytest.raises(ValueError):
        schist_geometry(100, 0, K2)
    with pytest.raises(ValueError):
        schist_geometry(100, 17, K2)


def _transpose(words):
    """(..., 32) words, lane i's bit j -> lane j's bit i."""
    bits = (words[..., :, None] >> np.arange(32, dtype=np.uint64)) & 1  # (..., lane, bit)
    return (np.swapaxes(bits, -1, -2) << np.arange(32, dtype=np.uint64)).sum(-1)


def _emulate(bits, cells, q, grid):
    """The kernel's walk and count, block by block and step by step."""
    qt, n_sub, k2 = bits.shape
    n = cells.shape[1]
    tiles, warps, _smem, groups = schist_geometry(q, n_sub, k2)
    n_planes = n_sub.bit_length()
    row = k2 + 1
    words = bits.astype(np.uint32).astype(np.uint64)
    n_chunks = -(-n // CHUNK)
    n_items = n_chunks * groups
    grid = min(grid, n_items)
    steps = CHUNK // (warps * 32)
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
                base = (item % n_chunks) * CHUNK + ((k % steps) * warps + warp) * 32
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
    rng = np.random.default_rng(n)
    d1s = torch.as_tensor(rng.uniform(0, 4, (n_sub, q, sqrt_k)).astype(np.float32))
    d2s = torch.as_tensor(rng.uniform(0, 4, (n_sub, q, sqrt_k)).astype(np.float32))
    taus = torch.as_tensor(rng.uniform(1, 5, (n_sub, q)).astype(np.float32))
    cells = torch.as_tensor(rng.integers(0, sqrt_k * sqrt_k, (n_sub, n)), dtype=torch.int32)
    bits = collision_bits(collision_table(d1s, d2s, taus))
    want = schist_plain(bits, cells, n_sub + 1, q=q)
    got = _emulate(bits.numpy(), cells.numpy(), q, grid)
    np.testing.assert_array_equal(got, want.numpy())
