"""Launch geometry of the masked re-rank kernel's pass a
(``kernels/masked_rerank.py:rerank_geometry``): a pure function of the
sizes, so it is held here on the CPU for every k, N_s and d the kernel
takes, at the paper's K = 1024 cells."""
import math

import pytest

from repro_torch.kernels.masked_rerank import (
    MAX_PARTIAL,
    MAX_SMEM,
    rerank_geometry,
)

K2 = 1024


@pytest.mark.parametrize("d", [3, 128])
@pytest.mark.parametrize("n_sub", [1, 6, 16])
@pytest.mark.parametrize("k", [1, 10, 32, 100, 512, 513, 1024])
def test_rerank_geometry(k, n_sub, d):
    for n in (1, 1003, 65536, 10 ** 6):
        lanes, warps, chunk, n_chunks, smem = rerank_geometry(n, k, n_sub, K2, d)
        assert smem <= MAX_SMEM
        # the heaps, the rings and the collision table are always there
        assert smem >= n_sub * K2 * 4 + k * lanes * 8 + warps * 64 * 8
        assert 1 <= warps <= 8
        assert chunk * n_chunks >= n and chunk * (n_chunks - 1) < n
        assert n_chunks * k <= MAX_PARTIAL
        assert lanes == (16 if k > 512 else 32)
        assert n_chunks <= 65535


def test_rerank_geometry_rows_in_shared_memory():
    """At the main path's shape the query rows sit in shared memory, at a
    padded stride of d + 4 floats."""
    lanes, warps, chunk, n_chunks, smem = rerank_geometry(10 ** 6, 10, 6, K2, 128)
    assert (lanes, warps, n_chunks) == (32, 8, math.ceil(10 ** 6 / 4096))
    assert smem == 6 * K2 * 4 + 10 * 32 * 8 + 256 + 8 * 512 + 32 * 132 * 4


def test_rerank_geometry_rejects():
    with pytest.raises(ValueError):
        rerank_geometry(100, 0, 6, K2, 128)
    with pytest.raises(ValueError):
        rerank_geometry(100, 1025, 6, K2, 128)
    with pytest.raises(ValueError):
        rerank_geometry(100, 10, 17, K2, 128)
    # a table plus state past shared memory
    with pytest.raises(ValueError):
        rerank_geometry(100, 512, 16, 4096, 128)
