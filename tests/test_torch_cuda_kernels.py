"""The port's CUDA kernels against their plain PyTorch versions on the card,
at small shapes. Marked ``cuda``: skipped where no CUDA device is present;
run on a machine with one by ``PYTHONPATH=src python -m pytest -m cuda
tests/test_torch_cuda_kernels.py``. Integer-valued inputs make every sum
exact, so all outputs match bit for bit."""
import numpy as np
import pytest
import torch

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _ints(rng, shape, dev, lo=-8, hi=9):
    return torch.as_tensor(rng.integers(lo, hi, shape).astype(np.float32), device=dev)


@pytest.mark.parametrize("m,n,d", [(1, 1, 1), (37, 29, 5), (1000, 32, 4)])
def test_l2dist_kernel(dev, m, n, d):
    from repro_torch.kernels.l2dist import l2dist_cuda, l2dist_plain

    rng = np.random.default_rng(m)
    x, y = _ints(rng, (m, d), dev), _ints(rng, (n, d), dev)
    assert torch.equal(l2dist_cuda(x, y), l2dist_plain(x, y))


@pytest.mark.parametrize("sqrt_k", [5, 32])
@pytest.mark.parametrize("q", [1, 37, 1000])
@pytest.mark.parametrize("sub_dims", [(8, 8, 8, 8, 8, 8), (21, 21, 23)])
def test_l2dist_pairs_kernel(dev, sub_dims, q, sqrt_k):
    """One batched launch equals one single-pair launch per (subspace,
    half) bit for bit on float inputs: halves of 4/4 (TaCo) and 10/11,
    11/12 (SuCo over 65 dims)."""
    from repro_torch.core.taco import _half_slices
    from repro_torch.kernels import cuda
    from repro_torch.kernels.l2dist import l2dist_cuda, l2dist_pairs_cuda, l2dist_pairs_plain

    rng = np.random.default_rng(q * sqrt_k + len(sub_dims))
    slices = _half_slices(sub_dims)
    d_max = max(w for _c, w in slices)
    x = torch.as_tensor(rng.standard_normal((q, sum(sub_dims))).astype(np.float32), device=dev)
    y = torch.zeros((len(slices), sqrt_k, d_max), device=dev)
    for p, (_c, w) in enumerate(slices):
        y[p, :, :w] = torch.as_tensor(rng.standard_normal((sqrt_k, w)).astype(np.float32))
    cuda.reset_launch_counts()
    got = l2dist_pairs_cuda(x, slices, y)
    assert cuda.launch_counts["l2dist"] == 1
    want = torch.stack([l2dist_cuda(x[:, c:c + w].contiguous(), y[p, :, :w].contiguous())
                        for p, (c, w) in enumerate(slices)])
    assert torch.equal(got, want)
    plain = l2dist_pairs_plain(x, slices, y)
    assert torch.allclose(got, plain, rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("n,k,d", [(1003, 13, 3), (5000, 32, 4), (257, 100, 40)])
def test_kmeans_assign_kernel(dev, n, k, d):
    from repro_torch.kernels.kmeans_assign import kmeans_assign_cuda, kmeans_assign_plain

    rng = np.random.default_rng(n)
    x, c = _ints(rng, (n, d), dev, -3, 4), _ints(rng, (k, d), dev, -3, 4)
    ga, gd = kmeans_assign_cuda(x, c)
    wa, wd = kmeans_assign_plain(x, c)
    assert torch.equal(ga, wa) and torch.equal(gd, wd)


def _padded_pairs(rng, n_pairs, n, k, dims, w, dev, ints: bool):
    """xs (P, n, w), cs (P, k, w) with pair p's first dims[p] columns drawn
    (small integers, or normal floats) and zeros past them."""
    xs = torch.zeros((n_pairs, n, w), device=dev)
    cs = torch.zeros((n_pairs, k, w), device=dev)
    for p, d in enumerate(dims):
        for t, rows in ((xs, n), (cs, k)):
            a = rng.integers(-3, 4, (rows, d)) if ints else rng.standard_normal((rows, d))
            t[p, :, :d] = torch.as_tensor(a.astype(np.float32), device=dev)
    return xs, cs


@pytest.mark.parametrize("n_pairs", [1, 3, 12])
@pytest.mark.parametrize("w", [3, 4, 12, 128])
@pytest.mark.parametrize("k", [13, "max"])
def test_kmeans_assign_pairs_kernel(dev, n_pairs, w, k):
    """One launch for P pairs against the plain version, bit for bit on
    integer inputs (many exact ties: the first index wins): ragged n, pairs
    of unequal widths zero-padded to w, k up to the shared-memory limit."""
    from repro_torch.kernels import cuda
    from repro_torch.kernels.kmeans_assign import (
        MAX_SMEM,
        kmeans_assign_pairs_cuda,
        kmeans_assign_pairs_plain,
    )

    k = MAX_SMEM // (4 * (w + 1)) if k == "max" else k
    dims = [max(1, w - p % 3) for p in range(n_pairs)]
    rng = np.random.default_rng(n_pairs * 1000 + w)
    xs, cs = _padded_pairs(rng, n_pairs, 1003, k, dims, w, dev, ints=True)
    cuda.reset_launch_counts()
    ga, gd = kmeans_assign_pairs_cuda(xs, cs, dims)
    assert cuda.launch_counts["kmeans_assign"] == 1
    wa, wd = kmeans_assign_pairs_plain(xs, cs, dims)
    assert torch.equal(ga, wa) and torch.equal(gd, wd)


@pytest.mark.parametrize("n_pairs", [1, 3])
@pytest.mark.parametrize("n,k,d", [(1003, 13, 3), (5000, 32, 4), (257, 100, 40), (4099, 32, 11)])
def test_kmeans_assign_pairs_equal_single_launches_on_floats(dev, n_pairs, n, k, d):
    """Float inputs: the batched launch over pairs padded to a multiple of 4
    equals, bit for bit, the single-pair entry at each pair's own width
    (zero padding changes no fmaf chain)."""
    from repro_torch.kernels.kmeans_assign import kmeans_assign_cuda, kmeans_assign_pairs_cuda

    rng = np.random.default_rng(n + d)
    dims = [d] * n_pairs
    xs, cs = _padded_pairs(rng, n_pairs, n, k, dims, -(-d // 4) * 4, dev, ints=False)
    ga, gd = kmeans_assign_pairs_cuda(xs, cs, dims)
    for p in range(n_pairs):
        sa, sd = kmeans_assign_cuda(xs[p, :, :d].contiguous(), cs[p, :, :d].contiguous())
        assert torch.equal(ga[p], sa) and torch.equal(gd[p].view(torch.int32),
                                                      sd.view(torch.int32))


@pytest.mark.parametrize("w", [4, 13, 64, 128])
@pytest.mark.parametrize("side", ["fits", "tiled", "ivf"])
def test_kmeans_assign_tiled_kernel(dev, w, side):
    """Both ways through the kernel, at the largest k whose centroids fit in
    shared memory and one past it (the tiled path), and at IVF's 1024 lists:
    integer inputs (many exact ties) bit for bit against the plain version,
    one launch each, for one pair and for three. Float inputs: the tiled
    answer over k centroids equals, bit for bit, the one-tile answer over
    the first k - 1 merged with the last centroid by the same strict '<'."""
    from repro_torch.kernels import cuda
    from repro_torch.kernels.kmeans_assign import (
        MAX_SMEM,
        kmeans_assign_cuda,
        kmeans_assign_pairs_cuda,
        kmeans_assign_pairs_plain,
        kmeans_assign_plain,
        tiled,
    )

    limit = MAX_SMEM // (4 * (w + 1))
    k = {"fits": limit, "tiled": limit + 1, "ivf": 1024}[side]
    assert tiled(k, w) == (side != "fits" and k > limit)
    rng = np.random.default_rng(w * 7 + len(side))
    x, c = _ints(rng, (2051, w), dev, -3, 4), _ints(rng, (k, w), dev, -3, 4)
    cuda.reset_launch_counts()
    ga, gd = kmeans_assign_cuda(x, c)
    assert cuda.launch_counts["kmeans_assign"] == 1
    wa, wd = kmeans_assign_plain(x, c)
    assert torch.equal(ga, wa) and torch.equal(gd, wd)
    dims = [w, max(1, w - 1), max(1, w - 2)]
    xs, cs = _padded_pairs(rng, 3, 1003, k, dims, w, dev, ints=True)
    ga, gd = kmeans_assign_pairs_cuda(xs, cs, dims)
    wa, wd = kmeans_assign_pairs_plain(xs, cs, dims)
    assert torch.equal(ga, wa) and torch.equal(gd, wd)
    if side != "tiled":
        return
    x = torch.as_tensor(rng.standard_normal((2051, w)).astype(np.float32), device=dev)
    c = torch.as_tensor(rng.standard_normal((k, w)).astype(np.float32), device=dev)
    ta, td = kmeans_assign_cuda(x, c)
    ha, hd = kmeans_assign_cuda(x, c[:-1].contiguous())  # fits: one tile
    la, ld = kmeans_assign_cuda(x, c[-1:].contiguous())
    last = ld < hd
    assert torch.equal(ta, torch.where(last, la + (k - 1), ha))
    assert torch.equal(td.view(torch.int32), torch.where(last, ld, hd).view(torch.int32))


def _one_tile_composition(x, c):
    """The one-tile kernel's answer over all of c, whatever k: one launch a
    chunk of centroids that fits in shared memory, merged in chunk order by
    the same strict '<' (an earlier chunk keeps a tie)."""
    from repro_torch.kernels.kmeans_assign import MAX_SMEM, kmeans_assign_cuda, tiled

    limit = MAX_SMEM // (4 * (c.shape[1] + 1))
    best_a = best_d = None
    for j0 in range(0, c.shape[0], limit):
        chunk = c[j0:j0 + limit].contiguous()
        assert not tiled(chunk.shape[0], chunk.shape[1])
        a, d = kmeans_assign_cuda(x, chunk)
        if best_d is None:
            best_a, best_d = a + j0, d
            continue
        take = d < best_d
        best_a, best_d = torch.where(take, a + j0, best_a), torch.where(take, d, best_d)
    return best_a, best_d


#: (w, k) through the tiled path: one past the shared-memory limit at each
#: width, and IVF's 1024 lists where they are past it
TILED_SHAPES = [(4, 11623), (13, 4151), (64, 895), (128, 451), (64, 1024), (128, 1024)]


@pytest.mark.parametrize("w,k", TILED_SHAPES)
@pytest.mark.parametrize("data", ["offset", "offset_narrow", "midway", "integer"])
def test_kmeans_assign_tiled_screen_cases(dev, w, k, data):
    """The tiled path's TF32 screen on data that strains it: a 10^3 offset a
    coordinate (spread 10^2, and unit spread, where the exact chain's own
    rounding widens the window to nearly every centroid), points halfway
    between two centroids (near-ties on floats), and small integers (exact
    ties). Floats bit for bit against the one-tile kernel's composition,
    integers against the plain version; one launch; the launch's recheck
    count is at least one a point and at most n k."""
    from repro_torch.kernels import cuda
    from repro_torch.kernels.kmeans_assign import (
        kmeans_assign_cuda,
        kmeans_assign_plain,
        last_tiled,
        tiled,
    )

    assert tiled(k, w)
    n = 2051
    rng = np.random.default_rng(w * 31 + k + len(data))
    if data == "offset":
        x, c = 1e3 + 100 * rng.standard_normal((n, w)), 1e3 + 100 * rng.standard_normal((k, w))
    elif data == "offset_narrow":
        x, c = 1e3 + rng.standard_normal((n, w)), 1e3 + rng.standard_normal((k, w))
    elif data == "midway":
        c = rng.standard_normal((k, w))
        x = (c[rng.integers(0, k, n)] + c[rng.integers(0, k, n)]) / 2
    else:
        x, c = rng.integers(-3, 4, (n, w)), rng.integers(-3, 4, (k, w))
    x = torch.as_tensor(np.asarray(x, np.float32), device=dev)
    c = torch.as_tensor(np.asarray(c, np.float32), device=dev)
    cuda.reset_launch_counts()
    ga, gd = kmeans_assign_cuda(x, c)
    assert cuda.launch_counts["kmeans_assign"] == 1
    rechecks = int(last_tiled["rechecks"].item())
    assert last_tiled["points"] == n and last_tiled["centroids"] == k
    assert n <= rechecks <= n * k
    wa, wd = kmeans_assign_plain(x, c) if data == "integer" else _one_tile_composition(x, c)
    assert torch.equal(ga, wa)
    assert torch.equal(gd.view(torch.int32), wd.view(torch.int32))


def test_kmeans_assign_pairs_kernel_rejects(dev):
    """What the reference rejects (no centroid, pairs that disagree) is
    refused; a width past 128, once refused, now runs (the wide path)."""
    from repro_torch.kernels.kmeans_assign import (
        kmeans_assign_cuda,
        kmeans_assign_pairs_cuda,
        kmeans_assign_pairs_plain,
    )

    with pytest.raises(ValueError):
        kmeans_assign_cuda(torch.zeros((10, 4), device=dev), torch.zeros((0, 4), device=dev))
    xs, cs = torch.zeros((2, 10, 132), device=dev), torch.zeros((2, 4, 132), device=dev)
    ga, gd = kmeans_assign_pairs_cuda(xs, cs)
    wa, wd = kmeans_assign_pairs_plain(xs, cs)
    assert torch.equal(ga, wa) and torch.equal(gd, wd)
    with pytest.raises(ValueError):
        kmeans_assign_pairs_cuda(torch.zeros((2, 10, 4), device=dev),
                                 torch.zeros((3, 4, 4), device=dev))


def test_build_on_the_card_matches_per_pair_build_on_integers(dev):
    """A SuCo build on the card (halves of 6/7 and 7/7 padded to 8) on an
    integer-valued corpus, where every float32 sum is exact in any order,
    equals bit for bit one k-means per (subspace, half) run on the card."""
    from repro_torch.clustering import kmeans
    from repro_torch.core import imi, taco
    from repro_torch.core.config import suco_config

    data = np.random.default_rng(1).integers(-20, 21, (20000, 40)).astype(np.float32)
    cfg = suco_config(n_subspaces=3, n_clusters=49, use_kernels=True)
    index = taco.build(data, cfg, device=dev)
    projected = taco._project(index, torch.as_tensor(data, device=dev))
    gen = torch.Generator().manual_seed(cfg.seed)
    for (lo, hi), sub in zip(taco._sub_slices(index.sub_dims), index.subspaces):
        s1, _s2 = imi.split_halves(hi - lo)
        c1, a1 = kmeans(projected[:, lo:lo + s1], cfg.sqrt_k, cfg.kmeans_iters, generator=gen)
        c2, a2 = kmeans(projected[:, lo + s1:hi], cfg.sqrt_k, cfg.kmeans_iters, generator=gen)
        assert torch.equal(sub.centroids1, c1) and torch.equal(sub.centroids2, c2)
        assert torch.equal(sub.assign1, a1) and torch.equal(sub.assign2, a2)


@pytest.mark.parametrize("config", ["taco", "suco"])
def test_builds_on_the_card_repeat_bit_for_bit(dev, config):
    """Two builds of one float corpus on the card give the same arrays bit
    for bit (the Lloyd update sums by one-hot products, not float atomics),
    so a compaction equals a rebuild over the same live corpus."""
    from repro_torch.ann.persistence import leaves_of
    from repro_torch.core import taco
    from repro_torch.core.config import suco_config, taco_config

    data = np.random.default_rng(2).standard_normal((30000, 40)).astype(np.float32)
    cfg = (taco_config(n_subspaces=3, subspace_dim=6, n_clusters=256, use_kernels=True)
           if config == "taco" else suco_config(n_subspaces=3, n_clusters=256, use_kernels=True))
    a, b = taco.build(data, cfg, device=dev), taco.build(data, cfg, device=dev)
    assert all(torch.equal(x, y) for x, y in zip(leaves_of(a), leaves_of(b)))


def _collision(rng, n_sub, q, sqrt_k, n, dev):
    from repro_torch.kernels.schist import collision_bits, collision_table

    d1s = torch.as_tensor(rng.uniform(0, 4, (n_sub, q, sqrt_k)).astype(np.float32), device=dev)
    d2s = torch.as_tensor(rng.uniform(0, 4, (n_sub, q, sqrt_k)).astype(np.float32), device=dev)
    taus = torch.as_tensor(rng.uniform(1, 5, (n_sub, q)).astype(np.float32), device=dev)
    cells = torch.as_tensor(rng.integers(0, sqrt_k * sqrt_k, (n_sub, n)), dtype=torch.int32,
                            device=dev)
    return collision_bits(collision_table(d1s, d2s, taus)), cells


@pytest.mark.parametrize("n_sub,q,sqrt_k,n", [(2, 3, 5, 50), (4, 33, 32, 1030), (6, 64, 32, 20000)])
def test_schist_kernel(dev, n_sub, q, sqrt_k, n):
    from repro_torch.kernels.schist import schist_cuda, schist_plain

    bits, cells = _collision(np.random.default_rng(q), n_sub, q, sqrt_k, n, dev)
    got = schist_cuda(bits, cells, n_sub + 1, q=q)
    assert torch.equal(got, schist_plain(bits, cells, n_sub + 1, q=q))
    assert bool((got.sum(1) == n).all())


@pytest.mark.parametrize("n_sub,q,k2,n,fill", [
    # N_s 1, 3, 6, 16; Q 1, 33, 37, 1000, 1025; n below one 2048-point chunk,
    # not a multiple of it, and 10^6
    (1, 1, 1024, 1000, "random"), (3, 33, 25, 5003, "random"),
    (6, 37, 1024, 20017, "random"), (6, 1000, 1024, 10 ** 6, "random"),
    (3, 1, 64, 10 ** 6, "random"), (8, 1000, 512, 20017, "random"),
    (16, 33, 256, 4099, "random"),
    # one tile a block: a 16 x 2048 table
    (16, 1025, 2048, 20017, "random"), (16, 37, 2048, 1000, "random"),
    # every cell activated (all points at level N_s) or none (level 0)
    (6, 1025, 1024, 10 ** 6, "ones"), (6, 1000, 1024, 2100, "zeros"),
    (16, 1025, 2048, 5003, "ones"),
])
def test_schist_kernel_tiles(dev, n_sub, q, k2, n, fill):
    """The multi-tile persistent kernel against the plain version on
    random packed words (the padding bits of the last tile set too), and
    on all-ones and all-zeros tables; every row sums to n."""
    from repro_torch.kernels import cuda
    from repro_torch.kernels.schist import schist_cuda, schist_geometry, schist_plain

    rng = np.random.default_rng(n_sub * q + n)
    qt = (q + 31) // 32
    if fill == "random":
        words = rng.integers(-2 ** 31, 2 ** 31, (qt, n_sub, k2))
    else:
        words = np.full((qt, n_sub, k2), -1 if fill == "ones" else 0)
    bits = torch.as_tensor(words, dtype=torch.int32, device=dev)
    cells = torch.as_tensor(rng.integers(0, k2, (n_sub, n)), dtype=torch.int32, device=dev)
    cuda.reset_launch_counts()
    got = schist_cuda(bits, cells, n_sub + 1, q=q)
    assert cuda.launch_counts["schist"] == 1
    want = schist_plain(bits, cells, n_sub + 1, q=q)
    assert torch.equal(got, want)
    assert bool((got.sum(1) == n).all())
    if fill != "random":
        assert bool((got[:, n_sub if fill == "ones" else 0] == n).all())
    if (n_sub, k2) == (16, 2048):
        assert schist_geometry(q, n_sub, k2)[0] == 1


@pytest.mark.parametrize("n_sub,q,sqrt_k,n,d,k,case", [
    (2, 3, 5, 50, 16, 5, "random"), (4, 5, 32, 1030, 16, 17, "random"),
    (3, 1, 8, 40, 8, 40, "random"), (6, 40, 16, 9000, 128, 100, "random"),
    (3, 20, 8, 3000, 24, 700, "random"),
    # threshold 0: every point passes, the rings fill on every group
    (4, 33, 16, 5000, 16, 10, "all"), (3, 20, 8, 3000, 24, 1024, "all"),
    # threshold N_s + 1: nothing passes, every slot stays (+inf, -1)
    (3, 40, 8, 2000, 24, 100, "none"),
    # threshold -1 (query-aware selection where every point fits the
    # budget): every point passes, as at 0
    (4, 33, 16, 5000, 16, 10, "below"), (20, 33, 64, 5000, 16, 10, "below"),
    # 37 distinct rows: equal distances resolve to the lowest id across
    # chunks, lanes and warps
    (3, 20, 8, 9000, 16, 50, "dup"), (2, 33, 8, 13000, 8, 1024, "dup"),
    # the 16-lane tile; d not a multiple of 4 (no float4 path); Q = 1, 33
    (3, 20, 8, 3000, 24, 1024, "random"), (2, 1, 5, 700, 3, 7, "random"),
    (4, 33, 32, 5003, 22, 17, "all"), (4, 33, 32, 5003, 22, 17, "random"),
])
def test_masked_rerank_kernel(dev, n_sub, q, sqrt_k, n, d, k, case):
    from repro_torch.kernels.masked_rerank import masked_rerank_cuda, masked_rerank_plain

    rng = np.random.default_rng(n + k)
    bits, cells = _collision(rng, n_sub, q, sqrt_k, n, dev)
    if case == "dup":
        data = _ints(rng, (37, d), dev)[torch.as_tensor(rng.integers(0, 37, n), device=dev)]
    else:
        data = _ints(rng, (n, d), dev)
    queries = _ints(rng, (q, d), dev)
    thresh = {"random": rng.integers(0, n_sub + 1, q), "dup": rng.integers(0, 2, q),
              "all": np.zeros(q), "none": np.full(q, n_sub + 1), "below": np.full(q, -1)}[case]
    thresh = torch.as_tensor(thresh, dtype=torch.int32, device=dev)
    norms = (data * data).sum(1)
    args = (bits, cells, thresh, queries, data, norms, k)
    gd, gi = masked_rerank_cuda(*args)
    wd, wi = masked_rerank_plain(*args)
    assert torch.equal(gi, wi) and torch.equal(gd, wd)
    if case == "none":
        assert bool((gi == -1).all()) and bool(torch.isinf(gd).all())


def test_masked_rerank_kernel_unaligned_rows(dev):
    """Rows at an offset of one float (no float4 path) give the same
    result."""
    from repro_torch.kernels.masked_rerank import masked_rerank_cuda, masked_rerank_plain

    rng = np.random.default_rng(3)
    n, d, q, k = 4000, 16, 40, 10
    bits, cells = _collision(rng, 3, q, 8, n, dev)
    data = _ints(rng, (n * d + 1,), dev)[1:].view(n, d)
    queries = _ints(rng, (q * d + 1,), dev)[1:].view(q, d)
    assert data.data_ptr() % 16 != 0 and data.is_contiguous()
    thresh = torch.as_tensor(rng.integers(0, 4, q), dtype=torch.int32, device=dev)
    args = (bits, cells, thresh, queries, data, (data * data).sum(1), k)
    gd, gi = masked_rerank_cuda(*args)
    wd, wi = masked_rerank_plain(*args)
    assert torch.equal(gi, wi) and torch.equal(gd, wd)


@pytest.mark.parametrize("n_sub,q,sqrt_k,n,d,k,share,case", [
    (4, 33, 16, 5003, 16, 10, 0.01, "random"), (3, 20, 8, 9000, 24, 1024, 0.3, "all"),
    (6, 40, 16, 9000, 128, 100, 0.5, "random"), (2, 7, 8, 1000, 8, 17, 1.0, "all"),
    (3, 33, 8, 13000, 8, 50, 0.05, "dup"),
])
def test_masked_rerank_kernel_exclusion(dev, n_sub, q, sqrt_k, n, d, k, share, case):
    """A tombstone bitmap: the kernel equals the plain version with the same
    bitmap, returns no excluded point, and its rows are those of a larger-k
    call without the bitmap with the excluded points dropped."""
    from repro_torch.kernels.masked_rerank import (
        masked_rerank_cuda,
        masked_rerank_plain,
        pack_exclusion,
    )

    rng = np.random.default_rng(n + k)
    bits, cells = _collision(rng, n_sub, q, sqrt_k, n, dev)
    if case == "dup":
        data = _ints(rng, (37, d), dev)[torch.as_tensor(rng.integers(0, 37, n), device=dev)]
    else:
        data = _ints(rng, (n, d), dev)
    queries = _ints(rng, (q, d), dev)
    thresh = np.zeros(q) if case == "all" else rng.integers(0, n_sub + 1, q)
    thresh = torch.as_tensor(thresh, dtype=torch.int32, device=dev)
    excluded = rng.random(n) < share
    words = pack_exclusion(excluded).to(dev)
    args = (bits, cells, thresh, queries, data, (data * data).sum(1), k)
    gd, gi = masked_rerank_cuda(*args, words)
    wd, wi = masked_rerank_plain(*args, words)
    assert torch.equal(gi, wi) and torch.equal(gd, wd)
    ids = gi[gi >= 0].cpu().numpy()
    assert not excluded[ids].any()
    if k + int(excluded.sum()) <= 1024:
        bd, bi = masked_rerank_cuda(*args[:-1], k + int(excluded.sum()))
        for row in range(q):
            keep = [j for j, i in enumerate(bi[row].tolist()) if i < 0 or not excluded[i]]
            assert torch.equal(gi[row], bi[row, keep[:k]])


@pytest.mark.parametrize("data", ["integer", "float"])
@pytest.mark.parametrize("k", [10, 100, 600])
def test_every_autotune_candidate_gives_the_default_output(dev, data, k):
    """Each (bq, bn) candidate of both ops launches with its tiles
    (``cuda.launch_blocks``) and gives the default tiles' output bit for
    bit, on an integer and a float corpus; n spans several chunks of every
    bn, Q a ragged last tile group."""
    from repro_torch.kernels import autotune, cuda
    from repro_torch.kernels.masked_rerank import masked_rerank_cuda
    from repro_torch.kernels.schist import schist_cuda

    rng = np.random.default_rng(k + len(data))
    n_sub, q, sqrt_k, n, d = 6, 200, 32, 40000, 32
    bits, cells = _collision(rng, n_sub, q, sqrt_k, n, dev)
    if data == "integer":
        x, qs = _ints(rng, (n, d), dev), _ints(rng, (q, d), dev)
    else:
        x = torch.as_tensor(rng.standard_normal((n, d)).astype(np.float32), device=dev)
        qs = torch.as_tensor(rng.standard_normal((q, d)).astype(np.float32), device=dev)
    thresh = torch.as_tensor(rng.integers(2, n_sub + 1, q), dtype=torch.int32, device=dev)
    args = (bits, cells, thresh, qs, x, (x * x).sum(1), k)
    want_h = schist_cuda(bits, cells, n_sub + 1, q=q)
    want_d, want_i = masked_rerank_cuda(*args)
    for blocks in autotune.CANDIDATES["schist"]:
        cuda.reset_launch_counts()
        got = schist_cuda(bits, cells, n_sub + 1, q=q, blocks=blocks)
        assert cuda.launch_blocks["schist"] == blocks and cuda.launch_counts["schist"] == 1
        assert torch.equal(got, want_h), blocks
    for blocks in autotune.CANDIDATES["masked_rerank"]:
        cuda.reset_launch_counts()
        gd, gi = masked_rerank_cuda(*args, blocks=blocks)
        assert cuda.launch_blocks["masked_rerank"] == blocks
        assert torch.equal(gi, want_i) and torch.equal(gd, want_d), blocks


def test_autotune_on_the_card(dev):
    """The search on the card: every candidate timed within the budget,
    the winner installed under the card's key, and the ops launching it."""
    from repro_torch.kernels import autotune, cuda, ops

    autotune.clear_cache()
    try:
        for op in autotune.OPS:
            res = autotune.autotune(op, q=64, n=20000, d=32, k=10, budget_s=10.0,
                                    impl="kernel", device="cuda")
            assert len(res["trials"]) == len(autotune.CANDIDATES[op])
            assert res["key"][:3] == [op, "cuda", "f32"]
            assert autotune.get_blocks(op, q=64, n=20000) == tuple(res["winner"])
        args, kwargs = autotune.synthetic_problem("masked_rerank", 64, 20000, 32, 6, 32, 10, 0,
                                                  dev)
        cuda.reset_launch_counts()
        ops.schist(*args[:2], 7, q=64)
        ops.masked_rerank(*args)
        for op in autotune.OPS:
            assert cuda.launch_blocks[op] == autotune.get_blocks(op, q=64, n=20000)
    finally:
        autotune.clear_cache()


def test_masked_rerank_resident_warps(dev):
    """The occupancy query answers at the main path's k = 10 and k = 100."""
    from repro_torch.kernels.masked_rerank import rerank_resident_warps

    for k in (10, 100):
        assert rerank_resident_warps(10 ** 6, k, 6, 1024, 128) >= 8


@pytest.mark.parametrize("n_sub,q,sqrt_k,n", [
    (2, 3, 5, 50), (4, 33, 32, 1030), (6, 64, 32, 20000), (3, 37, 8, 8193),
])
def test_scscore_kernel(dev, n_sub, q, sqrt_k, n):
    from repro_torch.kernels.scscore import scscore_cuda, scscore_plain

    bits, cells = _collision(np.random.default_rng(q + n), n_sub, q, sqrt_k, n, dev)
    got = scscore_cuda(bits, cells, q=q)
    assert torch.equal(got, scscore_plain(bits, cells, q=q))
    assert int(got.min()) >= 0 and int(got.max()) <= n_sub


@pytest.mark.parametrize("rerank", ["gather", "masked_full"])
@pytest.mark.parametrize("selection", ["query_aware", "fixed"])
def test_query_on_the_card_matches_the_cpu(dev, rerank, selection):
    """Both pipelines end to end: the kernel route on the card against the
    plain route on the CPU, on an index with integer centroids (every f32
    sum exact), bit for bit."""
    import dataclasses

    from repro_torch.core import taco
    from repro_torch.core.config import taco_config

    rng = np.random.default_rng(5)
    data = rng.integers(-10, 11, (3000, 24)).astype(np.float32)
    queries = torch.as_tensor(rng.integers(-10, 11, (40, 24)).astype(np.float32))
    cfg = taco_config(n_subspaces=3, subspace_dim=6, n_clusters=64, alpha=0.05, beta=0.02,
                      transform="none", rerank=rerank, selection=selection, k=10)
    built = taco.build(data, cfg, device="cpu")
    arrays = {"data": built.data, "dim_perm": built.dim_perm}
    for i, sub in enumerate(built.subspaces):
        sub = dataclasses.replace(sub, centroids1=sub.centroids1.round(),
                                  centroids2=sub.centroids2.round())
        for name in ("centroids1", "centroids2", "assign1", "assign2", "cell_sizes"):
            arrays[f"subspaces.{i}.{name}"] = getattr(sub, name)
    cpu = taco.index_from_arrays(arrays, built.sub_dims, device="cpu")
    card = taco.index_from_arrays(arrays, built.sub_dims, device=dev)
    wi, wd, ws = taco.query_with_stats(cpu, queries, cfg)
    gi, gd, gs = taco.query_with_stats(card, queries, dataclasses.replace(cfg, use_kernels=True))
    assert torch.equal(gi.cpu(), wi) and torch.equal(gd.cpu(), wd)
    for key in ("sc_threshold", "candidate_demand", "truncated"):
        assert torch.equal(gs[key].cpu(), ws[key]), key


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("bh,s,t,hd,causal", [
    (2, 16, 16, 8, True), (3, 32, 32, 16, False), (1, 150, 150, 16, True),
    (2, 64, 130, 24, False), (2, 100, 257, 16, False), (2, 300, 200, 64, True),
    (1, 129, 129, 128, True), (2, 70, 50, 96, False),
    # the key ring wraps several times (T >= 4 key tiles of 128)
    (2, 200, 700, 64, False), (1, 600, 600, 64, True),
    # head dims across both templates; 20 takes the wrapper's aligned copy
    (2, 40, 300, 8, False), (2, 77, 600, 20, True), (1, 130, 520, 24, False),
    (1, 520, 520, 96, True), (1, 300, 600, 128, False),
    # one query row; more queries than keys under the causal mask
    (3, 1, 300, 64, True), (2, 1, 50, 128, False), (2, 300, 70, 64, True),
    # served prompts shorter than one tile: 32 heads of 64, S = T in 2-63
    (32, 4, 4, 64, True), (32, 23, 23, 64, True), (1, 2, 2, 64, True), (1, 63, 63, 64, True),
])
def test_flash_attention_kernel(dev, bh, s, t, hd, causal, dtype):
    """Ragged S and T, S != T both ways, every head-dim template; against
    the plain version at the reference tests' tolerances."""
    from repro_torch.kernels.flash_attention import flash_attention_cuda, flash_attention_plain

    rng = np.random.default_rng(bh * 1000 + s + t + hd)
    dt = getattr(torch, dtype)
    q, k, v = (torch.as_tensor(rng.standard_normal((bh, n, hd)).astype(np.float32),
                               device=dev).to(dt) for n in (s, t, t))
    got = flash_attention_cuda(q, k, v, causal)
    want = flash_attention_plain(q, k, v, causal)
    assert got.dtype == dt and got.shape == (bh, s, hd)
    tol = 2e-5 if dtype == "float32" else 5e-2
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_kernel_offset_view(dev, dtype):
    """Inputs that are views at an offset of one element (bases not 16-byte
    aligned) go through the wrapper's aligned copy and give the same
    result."""
    from repro_torch.kernels.flash_attention import flash_attention_cuda, flash_attention_plain

    rng = np.random.default_rng(11)
    dt = getattr(torch, dtype)
    bh, s, t, hd = 2, 150, 260, 64

    def view(n):
        flat = torch.as_tensor(rng.standard_normal(bh * n * hd + 1).astype(np.float32),
                               device=dev).to(dt)
        return flat[1:].view(bh, n, hd)

    q, k, v = view(s), view(t), view(t)
    assert q.data_ptr() % 16 != 0 and q.is_contiguous()
    got = flash_attention_cuda(q, k, v, True)
    tol = 2e-5 if dtype == "float32" else 5e-2
    torch.testing.assert_close(got.float(), flash_attention_plain(q, k, v, True).float(),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("hd", [64, 128])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_bf16_against_f32(dev, hd, causal):
    """The bf16 kernel against the plain version run in f32 on the same
    (upcast) inputs, per element within 2^-7 |x| + 4e-5: one rounding of
    the output plus f32 noise. It holds only if P enters P.V with more
    than bf16's precision (the kernel's hi + lo split)."""
    from repro_torch.kernels.flash_attention import flash_attention_cuda, flash_attention_plain

    rng = np.random.default_rng(hd + causal)
    q, k, v = (torch.as_tensor(rng.standard_normal((2, 1024, hd)).astype(np.float32),
                               device=dev).to(torch.bfloat16) for _ in range(3))
    got = flash_attention_cuda(q, k, v, causal).float()
    want = flash_attention_plain(q.float(), k.float(), v.float(), causal)
    used = float(((got - want).abs() / (4e-5 + 2.0 ** -7 * want.abs())).max())
    assert used <= 1.0, used


def test_flash_attention_kernel_rejects(dev):
    from repro_torch.kernels.flash_attention import flash_attention_cuda

    x = torch.zeros((1, 4, 8), device=dev)
    with pytest.raises(ValueError, match="head dim"):
        flash_attention_cuda(*(torch.zeros((1, 4, 129), device=dev),) * 3)
    with pytest.raises(ValueError, match="S, T >= 1"):
        flash_attention_cuda(x, x[:, :0], x[:, :0])
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        flash_attention_cuda(x.half(), x.half(), x.half())


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_lm_forward_through_the_kernel(dev, compute_dtype):
    """An LM forward (granite-3-2b smoke, 2 layers, 4 heads of 16, 2 KV
    heads) through the flash kernel: one launch a layer, no aligned copy,
    logits against the plain path (impl="torch") on the same weights:
    float32 within 1e-4. In bf16 the plain path rounds the scores and the
    probabilities to bf16 where the kernel keeps them in float32, so the
    kernel path must be no further from the float32 result, on average,
    than the plain bf16 path is (10 % slack for the two paths' own output
    roundings)."""
    import dataclasses

    from repro_torch.configs import get_smoke
    from repro_torch.kernels import cuda
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import model as M

    cfg = dataclasses.replace(get_smoke("granite-3-2b"), compute_dtype=compute_dtype)
    params = M.init_params(torch.Generator(device=dev).manual_seed(0), cfg, device=dev)
    rng = np.random.default_rng(7)
    tokens = torch.as_tensor(rng.integers(0, cfg.vocab_size, (2, 100)), device=dev)
    copies = fa.aligned_copies
    cuda.reset_launch_counts()
    got = M.forward(params, cfg, {"tokens": tokens})[0]
    torch.cuda.synchronize()
    assert cuda.launch_counts["flash_attention"] == cfg.n_layers
    assert fa.aligned_copies == copies
    want = M.forward(params, cfg, {"tokens": tokens}, impl="torch")[0]
    if compute_dtype == "float32":
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
    else:
        f32 = dataclasses.replace(cfg, compute_dtype="float32")
        exact = M.forward(params, f32, {"tokens": tokens}, impl="torch")[0]
        assert torch.isfinite(got).all()
        assert (got - exact).abs().mean() <= 1.1 * (want - exact).abs().mean()


def test_lm_training_gradients_through_the_kernel(dev):
    """A training step's gradients (granite-3-2b smoke, float32, remat on)
    through the flash kernel's autograd Function: flash launched twice a
    layer (forward and the recompute), every leaf within 1e-4 relative of
    the plain path's, the attention weights' gradients non-zero (a kernel
    output cut from the graph would leave wq, wk and wv none)."""
    from repro_torch.configs import get_smoke
    from repro_torch.data import SyntheticTokenStream
    from repro_torch.kernels import cuda
    from repro_torch.models import model as M
    from repro_torch.train import loss_fn
    from repro_torch.utils import tree_flatten

    cfg = get_smoke("granite-3-2b")
    params = M.init_params(torch.Generator(device=dev).manual_seed(0), cfg, device=dev)
    leaves, rebuild = tree_flatten(params)
    for p in leaves:
        p.requires_grad_(True)
    batch = {k: torch.as_tensor(v, device=dev).long()
             for k, v in SyntheticTokenStream(cfg.vocab_size, 64, 4).batch(0).items()}
    grads = {}
    for impl in ("auto", "torch"):
        cuda.reset_launch_counts()
        loss, _ = loss_fn(rebuild(leaves), cfg, batch, impl=impl)
        grads[impl] = torch.autograd.grad(loss, leaves)
        torch.cuda.synchronize()
        assert cuda.launch_counts["flash_attention"] == (2 * cfg.n_layers if impl == "auto" else 0)
    for got, want in zip(grads["auto"], grads["torch"]):
        assert float((got - want).norm()) <= 1e-4 * float(want.norm())
    attn = rebuild(list(grads["auto"]))["blocks"]["l0"]["attn"]
    assert all(float(attn[name]["w"].norm()) > 0 for name in ("wq", "wk", "wv", "wo"))


@pytest.mark.parametrize("w,k", [(129, 3), (160, 100), (250, 64), (960, 1024), (961, 70)])
def test_kmeans_assign_wide_kernel(dev, w, k):
    """Widths past 128 (the wide tiled path: points streamed in chunks of
    64 features): integer inputs bit for bit against the plain version, for
    one pair and for three of unequal widths padded to w, one launch each,
    counted as ``tiled_wide``; the recheck count is at least one a point."""
    from repro_torch.kernels import cuda
    from repro_torch.kernels.kmeans_assign import (
        kmeans_assign_cuda,
        kmeans_assign_pairs_cuda,
        kmeans_assign_pairs_plain,
        kmeans_assign_plain,
        last_tiled,
        tiled,
    )

    assert tiled(k, w)
    rng = np.random.default_rng(w + k)
    n = 2051
    x, c = _ints(rng, (n, w), dev, -3, 4), _ints(rng, (k, w), dev, -3, 4)
    cuda.reset_launch_counts()
    ga, gd = kmeans_assign_cuda(x, c)
    assert cuda.launch_counts["kmeans_assign"] == 1
    assert cuda.launch_layouts["kmeans_assign"] == {"tiled_wide": 1}
    assert n <= int(last_tiled["rechecks"].item()) <= n * k
    wa, wd = kmeans_assign_plain(x, c)
    assert torch.equal(ga, wa) and torch.equal(gd, wd)
    dims = [w, w - 1, w - 2]
    xs, cs = _padded_pairs(rng, 3, 1003, k, dims, w, dev, ints=True)
    ga, gd = kmeans_assign_pairs_cuda(xs, cs, dims)
    wa, wd = kmeans_assign_pairs_plain(xs, cs, dims)
    assert torch.equal(ga, wa) and torch.equal(gd, wd)


@pytest.mark.parametrize("w,k,run", [(960, 1024, 3), (129, 70, 1), (200, 5, 2)])
def test_kmeans_assign_wide_kernel_in_runs(dev, w, k, run, monkeypatch):
    """A scratch of ``run`` row blocks (WIDE_RUN_BYTES cut to it): the
    launch walks the points in runs, still one launch, and gives bit for
    bit the one-run launch's answer on floats and the plain version's on
    integers, for one pair and for three."""
    from repro_torch.kernels import cuda
    from repro_torch.kernels import kmeans_assign as K

    rng = np.random.default_rng(w * run + k)
    n = 5 * K.TILE_POINTS + 17
    x = torch.as_tensor(rng.standard_normal((n, w)).astype(np.float32), device=dev)
    c = torch.as_tensor(rng.standard_normal((k, w)).astype(np.float32), device=dev)
    xs, cs = _padded_pairs(rng, 3, n, k, [w, w - 1, w - 1], w, dev, ints=True)
    whole = K.kmeans_assign_cuda(x, c)
    wa, wd = K.kmeans_assign_pairs_plain(xs, cs, [w, w - 1, w - 1])
    wp = -(-w // K.WIDE_CHUNK) * K.WIDE_CHUNK
    for pairs in (1, 3):
        monkeypatch.setattr(K, "WIDE_RUN_BYTES", 4 * pairs * K.TILE_POINTS * (wp + 2) * run)
        assert K.wide_run_blocks(pairs, n, w, sms=132) == run
    cuda.reset_launch_counts()
    monkeypatch.setattr(K, "WIDE_RUN_BYTES", 4 * K.TILE_POINTS * (wp + 2) * run)
    ga, gd = K.kmeans_assign_cuda(x, c)
    assert cuda.launch_counts["kmeans_assign"] == 1
    assert torch.equal(ga, whole[0]) and torch.equal(gd.view(torch.int32),
                                                     whole[1].view(torch.int32))
    monkeypatch.setattr(K, "WIDE_RUN_BYTES", 4 * 3 * K.TILE_POINTS * (wp + 2) * run)
    ga, gd = K.kmeans_assign_pairs_cuda(xs, cs, [w, w - 1, w - 1])
    assert torch.equal(ga, wa) and torch.equal(gd, wd)


@pytest.mark.parametrize("d,w,k", [(100, 160, 64), (128, 960, 1024), (37, 200, 5), (3, 130, 13)])
@pytest.mark.parametrize("data", ["gaussian", "offset", "midway"])
def test_kmeans_assign_wide_kernel_on_floats(dev, d, w, k, data):
    """Float inputs through the wide path: pairs of width d zero-padded to
    w > 128 equal, bit for bit, single launches at width d (the one-tile
    kernel, or the resident-points tiled path at 1024 lists): zero padding
    changes no chain, so the wide screen and rechecks must find the same
    first minimiser as the arithmetic of the kernels already held."""
    from repro_torch.kernels.kmeans_assign import kmeans_assign_cuda, kmeans_assign_pairs_cuda

    rng = np.random.default_rng(d * w + k + len(data))
    n = 3001
    if data == "offset":
        x, c = 1e3 + 100 * rng.standard_normal((n, d)), 1e3 + 100 * rng.standard_normal((k, d))
    elif data == "midway":
        c = rng.standard_normal((k, d))
        x = (c[rng.integers(0, k, n)] + c[rng.integers(0, k, n)]) / 2
    else:
        x, c = rng.standard_normal((n, d)), rng.standard_normal((k, d))
    xs = torch.zeros((2, n, w), device=dev)
    cs = torch.zeros((2, k, w), device=dev)
    xs[:, :, :d] = torch.as_tensor(np.asarray(x, np.float32), device=dev)
    cs[:, :, :d] = torch.as_tensor(np.asarray(c, np.float32), device=dev)
    ga, gd = kmeans_assign_pairs_cuda(xs, cs, [d, d])
    sa, sd = kmeans_assign_cuda(xs[0, :, :d].contiguous(), cs[0, :, :d].contiguous())
    for p in range(2):
        assert torch.equal(ga[p], sa)
        assert torch.equal(gd[p].view(torch.int32), sd.view(torch.int32))


#: (N_s, Q, K, n) past the fast collision kernels: N_s above 16, a table
#: past shared memory (20 x 4096 words, 6 x 16384), both (127 x 1024)
WIDE_COLLISIONS = [
    (17, 37, 1024, 20017), (20, 65, 4096, 30011), (127, 33, 64, 5003),
    (127, 70, 1024, 20017), (6, 33, 16384, 10007), (31, 1, 256, 4099), (40, 96, 100, 8000),
]


@pytest.mark.parametrize("n_sub,q,k2,n", WIDE_COLLISIONS)
def test_schist_kernel_wide(dev, n_sub, q, k2, n):
    """The wide schist kernel bit for bit against the plain version on
    random packed words and on all-ones words; every row sums to n; the
    launch counted where its table lived."""
    from repro_torch.kernels import cuda
    from repro_torch.kernels.schist import schist_cuda, schist_geometry, schist_plain

    rng = np.random.default_rng(n_sub * q + n)
    qt = (q + 31) // 32
    g = schist_geometry(q, n_sub, k2)
    assert g.wide
    for words in (rng.integers(-2 ** 31, 2 ** 31, (qt, n_sub, k2)),
                  np.full((qt, n_sub, k2), -1)):
        bits = torch.as_tensor(words, dtype=torch.int32, device=dev)
        cells = torch.as_tensor(rng.integers(0, k2, (n_sub, n)), dtype=torch.int32, device=dev)
        cuda.reset_launch_counts()
        got = schist_cuda(bits, cells, n_sub + 1, q=q)
        assert cuda.launch_layouts["schist"] == {f"table={g.table}": 1}
        assert torch.equal(got, schist_plain(bits, cells, n_sub + 1, q=q))
        assert bool((got.sum(1) == n).all())


@pytest.mark.parametrize("n_sub,q,k2,n", WIDE_COLLISIONS)
def test_scscore_kernel_wide(dev, n_sub, q, k2, n):
    """scscore past 16 subspaces or past shared memory bit for bit against
    the plain version, each launch counted where its table lived."""
    from repro_torch.kernels import cuda
    from repro_torch.kernels.scscore import scscore_cuda, scscore_plain, scscore_table

    rng = np.random.default_rng(n_sub + q + n)
    qt = (q + 31) // 32
    bits = torch.as_tensor(rng.integers(-2 ** 31, 2 ** 31, (qt, n_sub, k2)), dtype=torch.int32,
                           device=dev)
    cells = torch.as_tensor(rng.integers(0, k2, (n_sub, n)), dtype=torch.int32, device=dev)
    cuda.reset_launch_counts()
    got = scscore_cuda(bits, cells, q=q)
    assert cuda.launch_layouts["scscore"] == {f"table={scscore_table(n_sub, k2)}": 1}
    assert torch.equal(got, scscore_plain(bits, cells, q=q))


def test_scscore_kernel_past_127_subspaces(dev):
    """N_s = 200 (32 SC planes): bit for bit against the plain version."""
    from repro_torch.kernels.scscore import scscore_cuda, scscore_plain

    rng = np.random.default_rng(200)
    bits, cells = _collision(rng, 200, 40, 8, 3001, dev)
    got = scscore_cuda(bits, cells, q=40)
    assert torch.equal(got, scscore_plain(bits, cells, q=40))
    assert int(got.max()) > 31


@pytest.mark.parametrize("n_sub,sqrt_k,k,n,share", [
    (6, 32, 1025, 30000, 0.0), (6, 32, 2048, 30000, 0.0), (6, 32, 8192, 30000, 0.0),
    (6, 32, 8192, 30000, 0.01), (4, 16, 30000, 40000, 0.01),
    (17, 32, 100, 20000, 0.0), (20, 64, 10, 20000, 0.0), (20, 64, 2048, 20000, 0.01),
    (127, 32, 50, 20000, 0.0), (127, 8, 1025, 20000, 0.01), (200, 8, 10, 5000, 0.0),
])
def test_masked_rerank_kernel_wide(dev, n_sub, sqrt_k, k, n, share):
    """k past 1024 (fewer lanes; one chunk at 8192; heaps in global memory
    at 30,000), N_s past 16 (the wide kernel; 200 takes 32 SC planes) and
    tables past shared memory (20 x 4096): integer inputs bit for bit
    against the plain version, with and without a tombstone bitmap; ties
    resolve to the lowest id; no excluded point returned."""
    from repro_torch.kernels import cuda
    from repro_torch.kernels.masked_rerank import (
        masked_rerank_cuda,
        masked_rerank_plain,
        pack_exclusion,
        rerank_geometry,
    )

    rng = np.random.default_rng(n_sub * k + n)
    q, d = 40, 24
    bits, cells = _collision(rng, n_sub, q, sqrt_k, n, dev)
    data = _ints(rng, (97, d), dev)[torch.as_tensor(rng.integers(0, 97, n), device=dev)]
    queries = _ints(rng, (q, d), dev)
    thresh = torch.as_tensor(rng.integers(0, max(1, n_sub // 3), q), dtype=torch.int32,
                             device=dev)
    excluded = rng.random(n) < share
    words = pack_exclusion(excluded).to(dev) if share else None
    args = (bits, cells, thresh, queries, data, (data * data).sum(1), k)
    g = rerank_geometry(n, k, n_sub, sqrt_k ** 2, d)
    cuda.reset_launch_counts()
    gd, gi = masked_rerank_cuda(*args, words)
    assert cuda.launch_layouts["masked_rerank"] == {f"table={g.table},heaps={g.heaps}": 1}
    wd, wi = masked_rerank_plain(*args, words)
    assert torch.equal(gi, wi) and torch.equal(gd, wd)
    if share:
        ids = gi[gi >= 0].cpu().numpy()
        assert not excluded[ids].any()


def _activation_problem(rng, n_sub, q, sqrt_k, dev, kind="float", size_hi=6):
    shape = (n_sub, q, sqrt_k)
    if kind == "float":
        d1s, d2s = (rng.uniform(0, 5, shape) for _ in range(2))
    elif kind == "int":  # many equal cell sums
        d1s, d2s = (rng.integers(0, 4, shape) for _ in range(2))
    else:  # negative sums, -0.0 + -0.0 = -0.0 and x + -x = +0.0
        vals = np.array([-2.0, -1.0, -0.0, 0.0, 1.0, 2.0], np.float32)
        d1s, d2s = (rng.choice(vals, shape) for _ in range(2))
    sizes = rng.integers(0, size_hi, (n_sub, sqrt_k, sqrt_k))
    return (torch.as_tensor(d1s.astype(np.float32), device=dev),
            torch.as_tensor(d2s.astype(np.float32), device=dev),
            torch.as_tensor(sizes.astype(np.int32), device=dev))


def _same_activation(got, want):
    for g, w in zip(got, want):
        assert g.shape == w.shape
        assert torch.equal(g.view(torch.int32), w.view(torch.int32))


@pytest.mark.parametrize("kind", ["float", "int", "signed_zero"])
@pytest.mark.parametrize("sqrt_k", [1, 4, 5, 12, 32, 40, 64, 65])
def test_sort_activation_kernel(dev, sqrt_k, kind):
    """The kernel against the plain sort_activation, tau and retrieved as
    bits: small and ragged sqrt_k with keys in registers, 40 and 64 (1,600
    and 4,096 cells) with keys in shared memory, 65 (4,225 cells) past both; ties, negative and signed-zero sums; alpha_n 0, one cell's
    weight, a cumulative weight, the total and past it."""
    from repro_torch.core.activation import sort_activation
    from repro_torch.kernels import cuda
    from repro_torch.kernels.activation import cells_layout, sort_activation_cuda

    place = "registers" if sqrt_k <= 32 else "shared" if sqrt_k <= 64 else "global"
    assert cells_layout(sqrt_k) == place
    rng = np.random.default_rng(sqrt_k * 10 + len(kind))
    d1s, d2s, sizes = _activation_problem(rng, 3, 37, sqrt_k, dev, kind)
    flat = sizes[0].flatten().long()
    total = int(flat.sum())
    for alpha_n in (0.0, float(flat.max()), float(flat[: flat.numel() // 3].sum()),
                    float(total), total + 7.5, 0.05 * total):
        cuda.reset_launch_counts()
        got = sort_activation_cuda(d1s, d2s, sizes, alpha_n)
        assert cuda.launch_counts["activation"] == 1
        assert cuda.launch_layouts["activation"] == {f"cells={place}": 1}
        _same_activation(got, sort_activation(d1s, d2s, sizes[:, None], alpha_n))


@pytest.mark.parametrize("n_sub,q,sqrt_k,n", [(6, 10240, 32, 10 ** 6), (20, 1024, 64, 10 ** 6)])
def test_sort_activation_kernel_at_the_cells_shapes(dev, n_sub, q, sqrt_k, n):
    """SIFT1M's and GIST1M's batches (N_s, Q, sqrt_k) with sizes that sum to
    n a subspace and alpha n = 0.05 n; then a repeat call gives the same
    bits."""
    from repro_torch.core.activation import sort_activation
    from repro_torch.kernels.activation import sort_activation_cuda

    rng = np.random.default_rng(q)
    d1s, d2s, _ = _activation_problem(rng, n_sub, q, sqrt_k, dev)
    cells = torch.as_tensor(rng.integers(0, sqrt_k ** 2, (n_sub, n)), device=dev)
    sizes = torch.stack([torch.bincount(c, minlength=sqrt_k ** 2) for c in cells])
    sizes = sizes.to(torch.int32).reshape(n_sub, sqrt_k, sqrt_k)
    got = sort_activation_cuda(d1s, d2s, sizes, 0.05 * n)
    _same_activation(got, sort_activation(d1s, d2s, sizes[:, None], 0.05 * n))
    _same_activation(sort_activation_cuda(d1s, d2s, sizes, 0.05 * n), got)


def test_sort_activation_kernel_repeats(dev):
    from repro_torch.kernels.activation import sort_activation_cuda

    d1s, d2s, sizes = _activation_problem(np.random.default_rng(3), 4, 300, 12, dev, "int")
    first = sort_activation_cuda(d1s, d2s, sizes, 40.0)
    for _ in range(3):
        _same_activation(sort_activation_cuda(d1s, d2s, sizes, 40.0), first)


def test_sort_activation_kernel_on_large_sizes(dev):
    """Sizes whose absolute total passes int32 take the int64 route in the
    kernel: tau and retrieved as an int64 transcription of the same
    arithmetic gives them (the plain version's f32 sums are not exact
    there)."""
    from repro_torch.kernels.activation import sort_activation_cuda

    rng = np.random.default_rng(9)
    d1s, d2s, _ = _activation_problem(rng, 2, 5, 4, dev, "int")
    sizes = torch.full((2, 4, 4), 2 ** 28, dtype=torch.int32, device=dev)
    taus, ret = sort_activation_cuda(d1s, d2s, sizes, 3.0 * 2 ** 28)
    sums = (d1s[..., :, None] + d2s[..., None, :]).flatten(-2)
    for s in range(2):
        for qi in range(5):
            ordered = torch.sort(sums[s, qi], stable=True)
            tau = ordered.values[2]  # the third cell reaches 3 x 2^28
            assert taus[s, qi] == tau
            below = int((sums[s, qi] < tau).sum()) * 2 ** 28
            ties = int((sums[s, qi] == tau).sum())
            want = below + max(1, 3 - below // 2 ** 28) * 2 ** 28
            assert ties >= 1 and ret[s, qi] == float(want)


@pytest.mark.parametrize("rerank", ["gather", "masked_full"])
def test_query_activation_kernel_matches_the_torch_route(dev, rerank, monkeypatch):
    """query_with_stats with use_kernels on the card, the activation once
    through the kernel and once forced onto the torch route by
    activation_taus' impl: ids, distances, taus and retrieved bit for bit;
    one activation launch a query."""
    from repro_torch.core import taco
    from repro_torch.core.config import taco_config
    from repro_torch.kernels import cuda

    rng = np.random.default_rng(8)
    data = torch.as_tensor(rng.standard_normal((20000, 32)).astype(np.float32))
    queries = torch.as_tensor(rng.standard_normal((300, 32)).astype(np.float32), device=dev)
    cfg = taco_config(n_subspaces=4, subspace_dim=8, n_clusters=256, alpha=0.05, beta=0.02,
                      rerank=rerank, k=10, use_kernels=True)
    index = taco.build(data, cfg, device=dev)
    cuda.reset_launch_counts()
    gi, gd, gs = taco.query_with_stats(index, queries, cfg)
    assert cuda.launch_counts["activation"] == 1
    real = taco.activation_taus
    monkeypatch.setattr(taco, "activation_taus",
                        lambda *a, impl="auto", **kw: real(*a, impl="torch", **kw))
    cuda.reset_launch_counts()
    wi, wd, ws = taco.query_with_stats(index, queries, cfg)
    assert cuda.launch_counts["activation"] == 0
    assert torch.equal(gi, wi) and torch.equal(gd, wd)
    for key in ("taus", "retrieved"):
        assert torch.equal(gs[key].view(torch.int32), ws[key].view(torch.int32)), key
