"""The port's masked-full query (and, in one check, the default gather
query) on an index built by ``repro`` and carried across with
``index_from_arrays``.

On an integer-valued index (integer corpus and queries, rounded centroids,
and for the entropy transform an integer mean and a 0/1 basis) every f32
sum on the path is exact whatever its order, so ids, dists, sc_threshold
and candidate_count must be bitwise-equal to
``repro.core.taco.query_with_stats(..., rerank="masked_full")``. On an
unmodified float gmm index the gate is centroid distances allclose at 1e-5,
>= 99% identical ids and recall@10 within 0.01.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import taco as jtaco
from repro.core.config import taco_config as j_taco_config
from repro.data import gmm_dataset as j_gmm_dataset
from repro.data import make_queries as j_make_queries
from repro.utils import exact_knn, recall_at_k
from repro_torch.ann import AnnIndex
from repro_torch.core import taco
from repro_torch.core.config import taco_config
from repro_torch.data import gmm_dataset, make_queries


def reference_arrays(index) -> dict:
    """The leaves of a ``repro.core.taco.SCIndex`` as numpy arrays, keyed
    as :func:`repro_torch.core.taco.index_from_arrays` reads them."""
    arrays = {"data": np.asarray(index.data), "data_norms": np.asarray(index.data_norms)}
    if index.transform is not None:
        for name in ("mean", "basis", "eigvals"):
            arrays[f"transform.{name}"] = np.asarray(getattr(index.transform, name))
    if index.dim_perm is not None:
        arrays["dim_perm"] = np.asarray(index.dim_perm)
    for i, sub in enumerate(index.subspaces):
        for name in ("centroids1", "centroids2", "assign1", "assign2", "cell_sizes"):
            arrays[f"subspaces.{i}.{name}"] = np.asarray(getattr(sub, name))
    return arrays


def integer_valued(index, seed: int = 0):
    """The same reference index with every float that enters a distance made
    an integer: rounded centroids and, for the entropy transform, an
    integer mean and a 0/1 column-selection basis. Every float32 sum on the
    query path is then exact whatever its order."""
    subs = tuple(
        dataclasses.replace(s, centroids1=jnp.round(s.centroids1),
                            centroids2=jnp.round(s.centroids2))
        for s in index.subspaces
    )
    index = dataclasses.replace(index, subspaces=subs)
    if index.transform is None:
        return index
    d, m = index.transform.basis.shape
    cols = np.random.default_rng(seed).permutation(d)[:m]
    basis = np.zeros((d, m), np.float32)
    basis[cols, np.arange(m)] = 1.0
    tr = dataclasses.replace(index.transform, basis=jnp.asarray(basis),
                             mean=jnp.round(index.transform.mean))
    return dataclasses.replace(index, transform=tr)


CFG = dict(n_subspaces=3, subspace_dim=6, n_clusters=64, alpha=0.05, beta=0.02,
           rerank="masked_full")


@pytest.fixture(scope="module", params=["entropy", "none"])
def int_index(request):
    rng = np.random.default_rng(11)
    data = rng.integers(-10, 11, (2000, 24)).astype(np.float32)
    queries = rng.integers(-10, 11, (12, 24)).astype(np.float32)
    ref = jtaco.build(data, j_taco_config(**CFG, transform=request.param))
    ref = integer_valued(ref)
    port = taco.index_from_arrays(reference_arrays(ref), ref.sub_dims, device="cpu")
    return request.param, ref, port, queries


@pytest.mark.parametrize("precision", ["f32", "bf16"])
@pytest.mark.parametrize("selection", ["query_aware", "fixed"])
@pytest.mark.parametrize("k", [1, 10, 50, 100])
def test_masked_full_bitwise_on_integer_index(int_index, k, selection, precision):
    transform, ref, port, queries = int_index
    kw = dict(CFG, transform=transform, selection=selection, precision=precision)
    wi, wd, ws = jtaco.query_with_stats(ref, jnp.asarray(queries), j_taco_config(**kw), k=k)
    gi, gd, gs = taco.query_with_stats(port, torch.from_numpy(queries), taco_config(**kw), k=k)
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
    np.testing.assert_array_equal(gd.numpy(), np.asarray(wd))
    for key in ("sc_threshold", "candidate_count", "candidate_demand", "truncated"):
        np.testing.assert_array_equal(gs[key].numpy(), np.asarray(ws[key]), err_msg=key)
    for key in ("taus", "retrieved"):
        np.testing.assert_array_equal(gs[key].numpy().view(np.uint32),
                                      np.asarray(ws[key]).view(np.uint32), err_msg=key)
    if k == 100 and selection == "query_aware":
        # k above the candidate count of some query: -1 / +inf slots
        assert (gi.numpy() == -1).any() and np.isinf(gd.numpy()).any()


def test_use_kernels_on_cpu_takes_the_plain_path(int_index):
    transform, ref, port, queries = int_index
    kw = dict(CFG, transform=transform, k=10)
    a = taco.query(port, torch.from_numpy(queries), taco_config(**kw))
    b = taco.query(port, torch.from_numpy(queries), taco_config(**kw, use_kernels=True))
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


def test_gather_rerank_is_not_ported(int_index):
    """Once a gap, now a gate: the default ``rerank="gather"`` searches,
    bitwise equal to the reference (tests/test_torch_gather.py has the
    full sweep)."""
    transform, ref, port, queries = int_index
    kw = dict(CFG, transform=transform, rerank="gather", k=10)
    assert taco_config().rerank == "gather"
    wi, wd, ws = jtaco.query_with_stats(ref, jnp.asarray(queries), j_taco_config(**kw))
    gi, gd, gs = taco.query_with_stats(port, torch.from_numpy(queries), taco_config(**kw))
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
    np.testing.assert_array_equal(gd.numpy(), np.asarray(wd))
    for key in ("sc", "sc_threshold", "candidate_count", "candidate_demand", "truncated"):
        np.testing.assert_array_equal(gs[key].numpy(), np.asarray(ws[key]), err_msg=key)
    fi, fd = AnnIndex(sc_index=port, cfg=taco_config(**kw)).search(queries)
    np.testing.assert_array_equal(fi, np.asarray(wi))
    np.testing.assert_array_equal(fd, np.asarray(wd))


@pytest.fixture(scope="module")
def gmm_index():
    data0 = gmm_dataset(4096 + 16, 32, seed=3)
    np.testing.assert_array_equal(data0, j_gmm_dataset(4096 + 16, 32, seed=3))
    data, queries = make_queries(data0, 16)
    jd, jq = j_make_queries(data0, 16)
    np.testing.assert_array_equal(data, jd)
    np.testing.assert_array_equal(queries, jq)
    cfg = dict(n_subspaces=4, subspace_dim=6, n_clusters=64, alpha=0.05, beta=0.02, k=10,
               rerank="masked_full")
    ref = jtaco.build(data, j_taco_config(**cfg))
    port = taco.index_from_arrays(reference_arrays(ref), ref.sub_dims, device="cpu")
    _gd, gt = exact_knn(data, queries, 10)
    return cfg, ref, port, queries, gt


def test_gmm_centroid_distances_allclose(gmm_index):
    cfg, ref, port, queries, _gt = gmm_index
    w1, w2 = jtaco._centroid_distances(ref, jnp.asarray(queries), False)
    g1, g2 = taco._centroid_distances(port, torch.from_numpy(queries), False)
    np.testing.assert_allclose(g1.numpy(), np.asarray(w1), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(g2.numpy(), np.asarray(w2), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("selection", ["query_aware", "fixed"])
def test_gmm_recall_parity(gmm_index, selection):
    cfg, ref, port, queries, gt = gmm_index
    kw = dict(cfg, selection=selection)
    wi, _wd = jtaco.query(ref, jnp.asarray(queries), j_taco_config(**kw))
    gi, _g = taco.query(port, torch.from_numpy(queries), taco_config(**kw))
    gi, wi = gi.numpy(), np.asarray(wi)
    assert np.mean(gi == wi) >= 0.99
    assert abs(recall_at_k(gi, gt, 10) - recall_at_k(wi, gt, 10)) <= 0.01


def test_ann_index_facade(gmm_index):
    cfg, ref, port, queries, _gt = gmm_index
    index = AnnIndex(sc_index=port, cfg=taco_config(**cfg))
    ids, dists = index.search(queries)
    ids2, dists2, stats = index.search_with_stats(torch.from_numpy(queries), k=5, beta=0.05)
    assert ids.shape == (16, 10) and ids2.shape == (16, 5)
    np.testing.assert_array_equal(
        ids, taco.query(port, torch.from_numpy(queries), taco_config(**cfg))[0].numpy())
    view = index.replace_cfg(selection="fixed")
    assert view.cfg.selection == "fixed" and view.sc_index is port
    one_ids, one_d, one_stats = index.search_with_stats(queries[0])
    np.testing.assert_array_equal(one_ids, ids[0])
    assert np.ndim(one_stats["candidate_count"]) == 0
    assert index.n == 4096 and index.d == 32
    assert index.index_bytes == ref.index_bytes
    assert dataclasses.asdict(index.cfg) == dataclasses.asdict(taco_config(**cfg))
