"""Launch geometry of the masked re-rank kernel's pass a
(``kernels/masked_rerank.py:rerank_geometry``): a pure function of the
sizes, so it is held here on the CPU for every k, N_s and d the kernel
takes, at the paper's K = 1024 cells."""
import math

import pytest

from repro_torch.kernels.autotune import CANDIDATES
from repro_torch.kernels.masked_rerank import (
    DEFAULT_BLOCKS,
    MAX_CHUNKS,
    MAX_PARTIAL,
    MAX_SMEM,
    rerank_geometry,
)

K2 = 1024


def _parent_geometry(n, k, n_sub, k2, d):
    """``rerank_geometry`` as it was before it took blocks (the untuned
    main path's launch)."""
    lanes = 32 if k <= 512 else 16
    base = n_sub * k2 * 4 + k * lanes * 8 + 256
    warps = min(8, (MAX_SMEM - base) // 512)
    smem = base + warps * 512
    rows = lanes * (d + 4 if d % 4 == 0 else d + 1) * 4
    if smem + rows <= MAX_SMEM:
        smem += rows
    n_chunks = max(1, min(math.ceil(n / 4096), MAX_PARTIAL // k))
    return lanes, warps, max(1, math.ceil(n / n_chunks)), n_chunks, smem


@pytest.mark.parametrize("d", [3, 128])
@pytest.mark.parametrize("n_sub", [1, 6, 16])
@pytest.mark.parametrize("k", [1, 10, 32, 100, 512, 513, 1024])
def test_rerank_geometry(k, n_sub, d):
    for n in (1, 1003, 65536, 10 ** 6):
        lanes, warps, chunk, n_chunks, smem, table, heaps = rerank_geometry(n, k, n_sub, K2, d)
        assert table == heaps == "shared"
        assert smem <= MAX_SMEM
        # the heaps, the rings and the collision table are always there
        assert smem >= n_sub * K2 * 4 + k * lanes * 8 + warps * 64 * 8
        assert 1 <= warps <= 8
        assert chunk * n_chunks >= n and chunk * (n_chunks - 1) < n
        assert n_chunks * k <= MAX_PARTIAL
        assert lanes == (16 if k > 512 else 32)
        assert n_chunks <= 65535


@pytest.mark.parametrize("n_sub,k2", [(1, 1024), (6, 1024), (16, 1024), (6, 25), (3, 4096)])
@pytest.mark.parametrize("k", [1, 10, 32, 100, 512, 513, 1024])
def test_rerank_geometry_without_blocks_is_the_parents(k, n_sub, k2):
    """No blocks, or the default ones: the geometry the kernel had before
    the cache, so the untuned path launches as it did."""
    for d in (3, 24, 128):
        for n in (1, 1003, 4096, 65536, 250_000, 10 ** 6):
            want = _parent_geometry(n, k, n_sub, k2, d)
            assert rerank_geometry(n, k, n_sub, k2, d)[:5] == want
            assert rerank_geometry(n, k, n_sub, k2, d, DEFAULT_BLOCKS)[:5] == want
            assert rerank_geometry(n, k, n_sub, k2, d)[5:] == ("shared", "shared")


@pytest.mark.parametrize("blocks", CANDIDATES["masked_rerank"])
@pytest.mark.parametrize("k", [10, 100, 1024])
def test_rerank_candidates_give_legal_launches(blocks, k):
    """Every candidate at the main path's shape (N_s 6, K 1024, d 128), its
    shard of 250,000 points and a small n gives what
    ``csrc/masked_rerank.cu`` takes: 32 or 16 lanes (16 above k = 512), 1
    to 8 warps, at most 65,535 chunks covering n, the partial lists within
    MAX_PARTIAL, pass a's and pass b's shared memory within the card's. The
    geometry does not depend on the batch (its grid has ceil(Q / lanes)
    tiles), so every engine bucket launches these."""
    for n in (1000, 250_000, 10 ** 6):
        lanes, warps, chunk, n_chunks, smem, *_ = rerank_geometry(n, k, 6, K2, 128, blocks)
        assert lanes == (16 if k > 512 or blocks[0] < 32 else 32)
        assert 1 <= warps <= 8 and smem <= MAX_SMEM
        assert 1 <= n_chunks <= MAX_CHUNKS and n_chunks * k <= MAX_PARTIAL
        assert chunk * n_chunks >= n and chunk * (n_chunks - 1) < n
        assert k * 24 + n_chunks * 8 <= MAX_SMEM  # pass b's lists
        # the chunk is bn wherever the partial cap does not bind
        if math.ceil(n / blocks[1]) <= MAX_PARTIAL // k:
            assert n_chunks == math.ceil(n / blocks[1])


def test_rerank_blocks_clamp():
    """bq between the two tile widths takes 16 lanes; a tiny bn is capped by
    the partial lists, a huge one is one chunk."""
    assert rerank_geometry(10 ** 6, 10, 6, K2, 128, (24, 4096))[0] == 16
    assert rerank_geometry(10 ** 6, 10, 6, K2, 128, (64, 4096))[0] == 32
    assert rerank_geometry(10 ** 6, 10, 6, K2, 128, (32, 1))[3] == MAX_PARTIAL // 10
    assert rerank_geometry(10 ** 6, 1, 6, K2, 128, (32, 1))[3] == MAX_PARTIAL
    assert rerank_geometry(10 ** 6, 10, 6, K2, 128, (32, 1 << 30))[2:4] == (10 ** 6, 1)


def test_rerank_geometry_rows_in_shared_memory():
    """At the main path's shape the query rows sit in shared memory, at a
    padded stride of d + 4 floats."""
    lanes, warps, chunk, n_chunks, smem, *_ = rerank_geometry(10 ** 6, 10, 6, K2, 128)
    assert (lanes, warps, n_chunks) == (32, 8, math.ceil(10 ** 6 / 4096))
    assert smem == 6 * K2 * 4 + 10 * 32 * 8 + 256 + 8 * 512 + 32 * 132 * 4


def _legal(g, n, k, n_sub, k2, d):
    """What ``masked_rerank_f32`` accepts: 1 to 32 lanes (a power of two),
    1 to 8 warps, chunks covering n, pass a's shared memory (the heaps and
    the table where they are staged, the rings, |q|^2 and the locks) within
    the card's, and pass b's lists too where it merges (2 chunks or more)."""
    assert g.lanes in (1, 2, 4, 8, 16, 32) and 1 <= g.warps <= 8
    assert g.chunk * g.n_chunks >= n and g.chunk * (g.n_chunks - 1) < n
    assert 1 <= g.n_chunks <= MAX_CHUNKS
    heaps = k * g.lanes * 8 if g.heaps == "shared" else 0
    table = n_sub * k2 * 4 if g.table == "shared" else 0
    assert heaps + table + 256 + g.warps * 512 <= g.smem <= MAX_SMEM
    assert g.n_chunks == 1 or k * 24 + g.n_chunks * 8 <= MAX_SMEM


def test_rerank_geometry_rejects():
    """What the reference rejects (k = 0, N_s = 0) is refused; every other
    shape gets a legal launch: k past 1024 with fewer lanes (8 at k = 2048,
    2 at 8192) and one chunk past the merge budget, heaps in global memory
    past what one lane's fits, N_s past 16, and tables past shared memory
    read from global memory."""
    with pytest.raises(ValueError):
        rerank_geometry(100, 0, 6, K2, 128)
    with pytest.raises(ValueError):
        rerank_geometry(100, 10, 0, K2, 128)
    for n in (100, 10 ** 6):
        for k in (1, 10, 1024, 1025, 2048, 8192, 40000):
            for n_sub, k2 in ((6, K2), (17, K2), (20, K2), (127, K2), (20, 4096), (16, 4096)):
                _legal(rerank_geometry(n, k, n_sub, k2, 128), n, k, n_sub, k2, 128)
    assert rerank_geometry(10 ** 6, 1025, 6, K2, 128)[::6] == (16, "shared")
    assert rerank_geometry(10 ** 6, 2048, 6, K2, 128)[::6] == (8, "shared")
    assert rerank_geometry(10 ** 6, 8192, 6, K2, 128)[0::3] == (2, 1, "shared")
    assert rerank_geometry(10 ** 6, 40000, 6, K2, 128).heaps == "global"
    assert rerank_geometry(10 ** 6, 10, 20, 4096, 128).table == "global"
    assert rerank_geometry(10 ** 6, 10, 127, K2, 128).table == "global"
    assert rerank_geometry(10 ** 6, 10, 17, K2, 128).table == "shared"
    # a table plus state past shared memory: the table leaves
    assert rerank_geometry(100, 512, 16, 4096, 128)[5:] == ("global", "shared")
