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


def test_kmeans_assign_pairs_kernel_rejects(dev):
    from repro_torch.kernels.kmeans_assign import (
        MAX_SMEM,
        kmeans_assign_cuda,
        kmeans_assign_pairs_cuda,
    )

    for w in (4, 128):
        k = MAX_SMEM // (4 * (w + 1)) + 1
        with pytest.raises(ValueError):
            kmeans_assign_pairs_cuda(torch.zeros((2, 10, w), device=dev),
                                     torch.zeros((2, k, w), device=dev))
        with pytest.raises(ValueError):
            kmeans_assign_cuda(torch.zeros((10, w), device=dev), torch.zeros((k, w), device=dev))
    with pytest.raises(ValueError):
        kmeans_assign_pairs_cuda(torch.zeros((2, 10, 132), device=dev),
                                 torch.zeros((2, 4, 132), device=dev))
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
              "all": np.zeros(q), "none": np.full(q, n_sub + 1)}[case]
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
