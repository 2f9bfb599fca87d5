"""The port's index build against the reference. jax.random and torch draw
different numbers and eigh leaves the sign and order of eigenvectors open,
so build parity is held four ways: Lloyd from injected centroids follows
the reference step by step on integer data; the allocation run on the
reference's eigensystem gives the same buckets; k-means++ reaches the
reference's inertia; an index built by the port reaches the recall of one
built by ``repro`` on the same data."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.clustering.kmeans import kmeans as j_kmeans
from repro.clustering.kmeans import kmeans_assign as j_kmeans_assign
from repro.clustering.kmeans import lloyd_step as j_lloyd_step
from repro.core import imi as jimi
from repro.core import taco as jtaco
from repro.core import transform as jT
from repro.core.config import taco_config as j_taco_config
from repro.data import gmm_dataset, make_queries
from repro.utils import exact_knn, recall_at_k
from repro_torch.ann import AnnIndex
from repro_torch.clustering import kmeans, lloyd_step
from repro_torch.core import imi, taco
from repro_torch.core import transform as T
from repro_torch.core.config import taco_config


@pytest.mark.parametrize("n,d,k,seed", [(500, 2, 8, 0), (3000, 4, 32, 1), (1200, 3, 16, 2)])
def test_lloyd_follows_reference_from_injected_centroids(n, d, k, seed):
    rng = np.random.default_rng(seed)
    data = rng.integers(-20, 21, (n, d)).astype(np.float32)
    init = rng.integers(-20, 21, (k, d)).astype(np.float32)
    init[-1] = 1000.0  # far away: an empty cluster keeps its centroid
    jc, tc = jnp.asarray(init), torch.from_numpy(init)
    tdata = torch.from_numpy(data)
    for _step in range(3):
        jc, ja = j_lloyd_step(jnp.asarray(data), jc)
        tc, ta = lloyd_step(tdata, tc)
        np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
        np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(tc[-1].numpy(), init[-1])
    c3, a3 = kmeans(tdata, k, iters=3, init_centroids=torch.from_numpy(init))
    jca, jaa = j_kmeans_assign(jnp.asarray(data), jc)
    np.testing.assert_allclose(c3.numpy(), np.asarray(jc), rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(a3.numpy(), np.asarray(jca))


def test_kmeans_random_init_is_seeded_and_kmeanspp_is_not_ported():
    """Once a gap, now a gate: both inits are seeded by the generator."""
    data = torch.from_numpy(np.random.default_rng(0).standard_normal((400, 3)).astype(np.float32))
    for init in ("random", "kmeans++"):
        a = kmeans(data, 8, 2, init, generator=torch.Generator().manual_seed(5))
        b = kmeans(data, 8, 2, init, generator=torch.Generator().manual_seed(5))
        c = kmeans(data, 8, 2, init, generator=torch.Generator().manual_seed(6))
        assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
        assert not torch.equal(a[0], c[0])
    with pytest.raises(ValueError):
        kmeans(data, 8, 2, init="bogus")


def _inertia(x: np.ndarray, c: np.ndarray) -> float:
    return float(((x[:, None, :] - c[None]) ** 2).sum(-1).min(1).mean())


@pytest.mark.parametrize("iters", [0, 2])
def test_kmeanspp_inertia_matches_reference(iters):
    """jax.random and torch draw different points, so k-means++ is held to
    the reference by quality: mean inertia over seeds within 10 % of the
    reference's k-means++, and no worse than the port's random init."""
    data = gmm_dataset(3000, 8, seed=2)
    x = torch.from_numpy(data)
    pp, rand, ref = [], [], []
    for seed in range(6):
        c, _ = kmeans(x, 32, iters, "kmeans++", generator=torch.Generator().manual_seed(seed))
        pp.append(_inertia(data, c.numpy()))
        c, _ = kmeans(x, 32, iters, "random", generator=torch.Generator().manual_seed(seed))
        rand.append(_inertia(data, c.numpy()))
        c, _ = j_kmeans(jax.random.PRNGKey(seed), jnp.asarray(data), 32, iters, "kmeans++")
        ref.append(_inertia(data, np.asarray(c)))
    assert abs(np.mean(pp) - np.mean(ref)) <= 0.1 * np.mean(ref), (pp, ref)
    assert np.mean(pp) <= np.mean(rand), (pp, rand)


def test_kmeanspp_build_searches():
    """An index seeded with k-means++ builds and, averaged over seeds,
    reaches the recall of one the reference seeds the same way (a single
    build varies by about 0.03 with its draws)."""
    data0 = gmm_dataset(4096 + 64, 32, seed=1)
    data, queries = make_queries(data0, 64)
    _gd, gt = exact_knn(data, queries, 10)
    r_port, r_ref = [], []
    for seed in range(3):
        kw = dict(n_subspaces=4, subspace_dim=6, n_clusters=64, alpha=0.05, beta=0.02, k=10,
                  kmeans_init="kmeans++", seed=seed)
        ref = jtaco.build(data, j_taco_config(**kw))
        wi, _ = jtaco.query(ref, jnp.asarray(queries), j_taco_config(**kw))
        gi, _ = AnnIndex.build(data, taco_config(**kw), device="cpu").search(queries)
        r_port.append(recall_at_k(gi, gt, 10))
        r_ref.append(recall_at_k(np.asarray(wi), gt, 10))
    assert abs(np.mean(r_port) - np.mean(r_ref)) <= 0.03, (r_port, r_ref)


@pytest.mark.parametrize("n_sub,s,d", [(2, 4, 16), (6, 8, 64), (3, 5, 15)])
def test_allocation_on_reference_eigensystem(n_sub, s, d):
    data = gmm_dataset(3000, d, seed=d)
    mean, vals, vecs = jT._cov_eig(jnp.asarray(data))
    vals, vecs = np.asarray(vals), np.asarray(vecs)
    assert T.eigensystem_allocation(vals, n_sub, s) == jT.eigensystem_allocation(vals, n_sub, s)
    got = T.allocate_from_eig(np.asarray(mean), vals, vecs, n_sub, s)
    want = jT.allocate_from_eig(mean, vals, vecs, n_sub, s)
    for name in ("mean", "basis", "eigvals"):
        np.testing.assert_array_equal(getattr(got, name).numpy(), np.asarray(getattr(want, name)))
    x = data[:7]
    np.testing.assert_allclose(T.apply_transform(got, torch.from_numpy(x)).numpy(),
                               np.asarray(jT.apply_transform(want, jnp.asarray(x))),
                               rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError):
        T.eigensystem_allocation(vals, n_sub, d)


def test_fit_transform_basis_matches_up_to_sign():
    """Well-separated spectrum: each eigenvector is unique up to its sign."""
    rng = np.random.default_rng(0)
    d = 12
    scales = np.geomspace(8.0, 0.5, d).astype(np.float32)
    rot, _ = np.linalg.qr(rng.standard_normal((d, d)))
    data = ((rng.standard_normal((20000, d)) * scales) @ rot.T).astype(np.float32)
    got = T.fit_transform(torch.from_numpy(data), 3, 4)
    want = jT.fit_transform(jnp.asarray(data), 3, 4)
    gb, wb = got.basis.numpy(), np.asarray(want.basis)
    signs = np.sign(np.sum(gb * wb, axis=0))
    np.testing.assert_allclose(gb * signs, wb, atol=1e-4)
    np.testing.assert_allclose(got.eigvals.numpy(), np.asarray(want.eigvals), rtol=1e-4)
    np.testing.assert_allclose(got.mean.numpy(), np.asarray(want.mean), rtol=1e-5, atol=1e-5)


def test_imi_helpers_match_reference():
    rng = np.random.default_rng(4)
    sqrt_k = 8
    a1 = rng.integers(0, sqrt_k, 999).astype(np.int32)
    a2 = rng.integers(0, sqrt_k, 999).astype(np.int32)
    np.testing.assert_array_equal(
        imi.cell_sizes(torch.from_numpy(a1), torch.from_numpy(a2), sqrt_k).numpy(),
        np.asarray(jimi.cell_sizes(jnp.asarray(a1), jnp.asarray(a2), sqrt_k)))
    assert imi.split_halves(7) == jimi.split_halves(7)
    c1 = rng.integers(-5, 6, (sqrt_k, 3)).astype(np.float32)
    c2 = rng.integers(-5, 6, (sqrt_k, 4)).astype(np.float32)
    pts = rng.integers(-5, 6, (300, 7)).astype(np.float32)
    sub = imi.IMISubspace(*(torch.from_numpy(a) for a in (c1, c2, a1, a2)),
                          cell_sizes=torch.zeros((sqrt_k, sqrt_k), dtype=torch.int32))
    jsub = jimi.IMISubspace(*(jnp.asarray(a) for a in (c1, c2, a1, a2)),
                            cell_sizes=jnp.zeros((sqrt_k, sqrt_k), jnp.int32))
    got = imi.assign_new_points(sub, torch.from_numpy(pts))
    want = jimi.assign_new_points(jsub, jnp.asarray(pts))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_suco_partition_matches_reference():
    got = taco.suco_dim_partition(23, 4, np.random.default_rng(9))
    want = jtaco.suco_dim_partition(23, 4, np.random.default_rng(9))
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1] == want[1]


@pytest.mark.parametrize("transform", ["entropy", "none"])
def test_port_build_recall_matches_reference_build(transform):
    data0 = gmm_dataset(4096 + 16, 32, seed=1)
    data, queries = make_queries(data0, 16)
    _gd, gt = exact_knn(data, queries, 10)
    kw = dict(n_subspaces=4, subspace_dim=6, n_clusters=64, alpha=0.05, beta=0.02, k=10,
              rerank="masked_full", transform=transform)
    ref = jtaco.build(data, j_taco_config(**kw))
    wi, _ = jtaco.query(ref, jnp.asarray(queries), j_taco_config(**kw))
    index = AnnIndex.build(data, taco_config(**kw, use_kernels=True), device="cpu")
    gi, _ = index.search(queries)
    r_port, r_ref = recall_at_k(gi, gt, 10), recall_at_k(np.asarray(wi), gt, 10)
    assert abs(r_port - r_ref) <= 0.03, (r_port, r_ref)
    sc = index.sc_index
    assert sc.data_norms.shape == (4096,) and sc.cells.shape == (4, 4096)
    assert int(sc.cell_sizes.sum()) == 4 * 4096
    assert index.index_bytes == ref.index_bytes
