"""The build's k-means in lockstep: P independent (points, centroids) pairs,
zero-padded to one width, assigned by one call and updated by one
``index_add_`` per Lloyd iteration (on the card, by one-hot products, held
here against ``index_add_`` on integers). On the CPU it must give bit for bit
what one k-means per pair gives (the loop written out below, as the port
ran it before), draw for draw from one seeded generator, and follow
``repro``'s Lloyd step on integer data."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.clustering.kmeans import lloyd_step as j_lloyd_step
from repro_torch.clustering import kmeans, kmeans_pairs, lloyd_step_pairs
from repro_torch.clustering.kmeans import _kmeanspp_init
from repro_torch.core import imi, taco
from repro_torch.core.config import suco_config, taco_config
from repro_torch.data import gmm_dataset
from repro_torch.kernels import ops
from repro_torch.kernels.kmeans_assign import kmeans_assign_pairs_plain, kmeans_assign_plain


def _stack(rng, n_pairs, n, dims, integer: bool):
    """(padded (P, n, w) stack, the pairs' unpadded (n, dims[p]) arrays);
    w is the widest pair rounded up to a multiple of 4."""
    w = -(-max(dims) // 4) * 4
    halves = [(rng.integers(-6, 7, (n, d)) if integer else rng.standard_normal((n, d)))
              .astype(np.float32) for d in dims]
    xs = np.zeros((n_pairs, n, w), np.float32)
    for p, h in enumerate(halves):
        xs[p, :, :h.shape[1]] = h
    return torch.from_numpy(xs), [torch.from_numpy(h) for h in halves]


def _per_pair_kmeans(data, k, iters, init, gen):
    """One pair's k-means as the port ran it before the lockstep loop: the
    draw, then Lloyd with ``index_add_`` means, then a final assignment."""
    data = data.contiguous()
    if init == "random":
        centroids = data[torch.randperm(data.shape[0], generator=gen)[:k]]
    else:
        centroids = _kmeanspp_init(data, k, gen)
    for _ in range(iters):
        idx = kmeans_assign_plain(data, centroids)[0].long()
        sums = torch.zeros((k, data.shape[1])).index_add_(0, idx, data)
        counts = torch.zeros((k,)).index_add_(0, idx, torch.ones_like(idx, dtype=torch.float32))
        centroids = torch.where(counts[:, None] > 0,
                                sums / torch.clamp_min(counts, 1.0)[:, None], centroids)
    return centroids, kmeans_assign_plain(data, centroids)[0]


def _bitwise(a: torch.Tensor, b: torch.Tensor) -> bool:
    return a.dtype == b.dtype and a.shape == b.shape and bool(
        torch.equal(a.contiguous().view(torch.int32), b.contiguous().view(torch.int32)))


@pytest.mark.parametrize("integer", [True, False])
@pytest.mark.parametrize("dims", [(4, 4, 4), (10, 11, 11, 12), (3,), (1, 7, 5)])
def test_pairs_plain_matches_per_pair_assignment(dims, integer):
    rng = np.random.default_rng(len(dims) * 7 + integer)
    n, k = 1003, 13
    xs, halves = _stack(rng, len(dims), n, dims, integer)
    cs, cents = _stack(rng, len(dims), k, dims, integer)
    ga, gd = kmeans_assign_pairs_plain(xs, cs, dims)
    oa, od = ops.kmeans_assign_pairs(xs, cs, dims)  # the CPU routes to the plain version
    assert ga.shape == (len(dims), n) and ga.dtype == torch.int32
    for p, (h, c) in enumerate(zip(halves, cents)):
        wa, wd = kmeans_assign_plain(h, c)
        assert torch.equal(ga[p], wa) and _bitwise(gd[p], wd)
        assert torch.equal(oa[p], wa) and _bitwise(od[p], wd)


def test_pairs_plain_rejects_bad_widths():
    xs, cs = torch.zeros((2, 5, 4)), torch.zeros((2, 3, 4))
    with pytest.raises(ValueError):
        kmeans_assign_pairs_plain(xs, cs, (4, 5))
    with pytest.raises(ValueError):
        kmeans_assign_pairs_plain(xs, cs, (4,))
    with pytest.raises(ValueError):
        kmeans_assign_pairs_plain(xs, torch.zeros((2, 3, 8)))


@pytest.mark.parametrize("init", ["random", "kmeans++"])
@pytest.mark.parametrize("dims", [(4, 4, 4, 4), (6, 7, 7, 7, 3)])
def test_lockstep_lloyd_matches_per_pair_loop(init, dims):
    """One seeded generator: the lockstep loop draws each pair's initial
    centroids in pair order, so every draw and every step equals the loop
    over pairs."""
    rng = np.random.default_rng(sum(dims))
    xs, halves = _stack(rng, len(dims), 800, dims, integer=False)
    got_c, got_a = kmeans_pairs(xs, 16, 4, init, dims=dims,
                                generator=torch.Generator().manual_seed(3))
    gen = torch.Generator().manual_seed(3)
    assert got_c.shape == (len(dims), 16, xs.shape[2]) and got_a.shape == (len(dims), 800)
    for p, h in enumerate(halves):
        want_c, want_a = _per_pair_kmeans(h, 16, 4, init, gen)
        assert _bitwise(got_c[p, :, :dims[p]], want_c), p
        assert torch.equal(got_a[p], want_a), p
        assert not bool(got_c[p, :, dims[p]:].any())  # the padding stays zero


@pytest.mark.parametrize("dims", [(2, 3), (4, 4, 4, 4, 4, 4), (10, 11, 11, 12)])
def test_lockstep_step_follows_reference_lloyd_step(dims):
    """Integer data: each pair's assignments equal ``repro``'s Lloyd step
    exactly and its centroids at 1e-5, step after step; a far-away centroid
    keeps its place (empty cluster)."""
    rng = np.random.default_rng(len(dims))
    k = 12
    xs, halves = _stack(rng, len(dims), 1500, dims, integer=True)
    cs, inits = _stack(rng, len(dims), k, dims, integer=True)
    cs[:, -1, :] = 0
    for p, d in enumerate(dims):
        cs[p, -1, :d] = 1000.0
    jcs = [jnp.asarray(cs[p, :, :d].numpy()) for p, d in enumerate(dims)]
    tc = cs
    for _step in range(3):
        tc, ta = lloyd_step_pairs(xs, tc, dims)
        for p, (h, d) in enumerate(zip(halves, dims)):
            jcs[p], ja = j_lloyd_step(jnp.asarray(h.numpy()), jcs[p])
            np.testing.assert_array_equal(ta[p].numpy(), np.asarray(ja))
            np.testing.assert_allclose(tc[p, :, :d].numpy(), np.asarray(jcs[p]),
                                       rtol=1e-5, atol=1e-5)
    for p, d in enumerate(dims):
        assert bool((tc[p, -1, :d] == 1000.0).all()) and not bool(tc[p, :, d:].any())


def test_kmeans_is_the_one_pair_case():
    rng = np.random.default_rng(8)
    data = torch.from_numpy(rng.standard_normal((600, 5)).astype(np.float32))
    c, a = kmeans(data, 8, 3, generator=torch.Generator().manual_seed(1))
    pc, pa = kmeans_pairs(data[None], 8, 3, generator=torch.Generator().manual_seed(1))
    assert _bitwise(c, pc[0]) and torch.equal(a, pa[0])
    wc, wa = _per_pair_kmeans(data, 8, 3, "random", torch.Generator().manual_seed(1))
    assert _bitwise(c, wc) and torch.equal(a, wa)


CONFIGS = {
    "taco": taco_config(n_subspaces=4, subspace_dim=5, n_clusters=64),
    "taco-kmeans++": taco_config(n_subspaces=3, subspace_dim=6, n_clusters=36,
                                 kmeans_init="kmeans++", seed=4),
    # 40 dims over 3 subspaces: 13, 13, 14, so halves of 6/7 and 7/7
    "suco": suco_config(n_subspaces=3, n_clusters=49),
    "suco-kmeans++": suco_config(n_subspaces=3, n_clusters=49, kmeans_init="kmeans++", seed=2),
}


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_build_matches_per_pair_build(name):
    """taco.build on the CPU gives, array for array and bit for bit, the
    index of one k-means per (subspace, half) run in order from one
    generator."""
    cfg = CONFIGS[name]
    data = gmm_dataset(2500, 40, seed=3)
    index = taco.build(data, cfg, device="cpu")
    projected = taco._project(index, torch.from_numpy(data))
    gen = torch.Generator().manual_seed(cfg.seed)
    assert len(index.subspaces) == cfg.n_subspaces
    for (lo, hi), sub in zip(taco._sub_slices(index.sub_dims), index.subspaces):
        s1, _s2 = imi.split_halves(hi - lo)
        c1, a1 = _per_pair_kmeans(projected[:, lo:lo + s1], cfg.sqrt_k, cfg.kmeans_iters,
                                  cfg.kmeans_init, gen)
        c2, a2 = _per_pair_kmeans(projected[:, lo + s1:hi], cfg.sqrt_k, cfg.kmeans_iters,
                                  cfg.kmeans_init, gen)
        assert _bitwise(sub.centroids1, c1) and _bitwise(sub.centroids2, c2)
        assert torch.equal(sub.assign1, a1) and torch.equal(sub.assign2, a2)
        assert torch.equal(sub.cell_sizes, imi.cell_sizes(a1, a2, cfg.sqrt_k))


@pytest.mark.parametrize("name", ["taco", "suco"])
def test_build_assigns_once_per_iteration(name, monkeypatch):
    """A build calls the batched assignment kmeans_iters + 1 times, for all
    2 N_s pairs at once, and the single-pair one never."""
    calls = {"pairs": 0, "single": 0}
    pairs, single = ops.kmeans_assign_pairs, ops.kmeans_assign

    def count_pairs(xs, cs, dims=None, impl="auto"):
        calls["pairs"] += 1
        assert xs.shape[0] == 2 * cfg.n_subspaces and xs.shape[2] % 4 == 0
        return pairs(xs, cs, dims, impl)

    def count_single(*args, **kw):
        calls["single"] += 1
        return single(*args, **kw)

    monkeypatch.setattr(ops, "kmeans_assign_pairs", count_pairs)
    monkeypatch.setattr(ops, "kmeans_assign", count_single)
    cfg = CONFIGS[name]
    taco.build(gmm_dataset(1200, 40, seed=1), cfg, device="cpu")
    assert calls == {"pairs": cfg.kmeans_iters + 1, "single": 0}


@pytest.mark.parametrize("segment,step", [(None, None), (64, 1000), (7, 37), (4096, 1)])
def test_onehot_sums_equal_index_add_on_integers(monkeypatch, segment, step):
    """The card's Lloyd sums (one-hot products over row segments, reduced
    in a fixed order, block by block) equal the CPU's ``index_add_`` sums
    where every float32 sum is exact, for any segment and block size (a
    segment longer than the rows, blocks of one segment and ragged ends
    included)."""
    import importlib

    kmod = importlib.import_module("repro_torch.clustering.kmeans")
    if segment is not None:
        monkeypatch.setattr(kmod, "_SEGMENT", segment)
        monkeypatch.setattr(kmod, "_ONEHOT_FLOATS", step * segment * 3 * 16)
    rng = np.random.default_rng(4)
    xs, _ = _stack(rng, 3, 5000, [4, 3, 4], integer=True)
    assign = torch.as_tensor(rng.integers(0, 16, (3, 5000)), dtype=torch.int32)
    want = torch.zeros((3 * 16, 4))
    idx = (assign.long() + torch.arange(3)[:, None] * 16).reshape(-1)
    want.index_add_(0, idx, xs.reshape(-1, 4))
    got = kmod._onehot_sums(xs, assign, 16)
    assert torch.equal(got.reshape(-1, 4), want)
