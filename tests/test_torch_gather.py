"""The port's gather query (Alg. 6 with a candidate cap, the reference's
default ``rerank="gather"``) against ``repro``.

The SC count is held bit for bit to the reference's Pallas kernel (run in
interpret mode) and its oracle. On the integer-valued index of
``test_torch_query`` every f32 sum is exact, so ids, dists and every stat,
``sc`` included, must equal ``repro.core.taco.query_with_stats`` bit for bit
for every configuration of ``config.py``, with and without truncation. On
the float gmm index the gate is the one ``test_gmm_recall_parity`` uses.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import taco as jtaco
from repro.core.config import ABLATIONS as J_ABLATIONS
from repro.data import gmm_dataset
from repro.data import make_queries as j_make_queries
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.utils import exact_knn, recall_at_k
from repro.utils import topk_smallest as j_topk_smallest
from repro_torch.ann import AnnIndex
from repro_torch.core import scoring, taco
from repro_torch.core.config import ABLATIONS, taco_config
from repro_torch.kernels import ops
from repro_torch.kernels.schist import cell_ids, collision_bits, collision_table
from repro_torch.kernels.scscore import scscore_plain
from repro_torch.utils import topk_smallest
from tests.test_torch_query import integer_valued, reference_arrays

STATS = ("sc", "sc_threshold", "candidate_count", "candidate_demand", "truncated")


def _scscore_case(rng, n_sub, q, sqrt_k, n):
    """The inputs of ``tests/test_kernels.py``'s scscore cases."""
    d1s = rng.uniform(0, 4, (n_sub, q, sqrt_k)).astype(np.float32)
    d2s = rng.uniform(0, 4, (n_sub, q, sqrt_k)).astype(np.float32)
    a1s = rng.integers(0, sqrt_k, (n_sub, n)).astype(np.int32)
    a2s = rng.integers(0, sqrt_k, (n_sub, n)).astype(np.int32)
    taus = rng.uniform(1, 5, (n_sub, q)).astype(np.float32)
    return d1s, d2s, a1s, a2s, taus


@pytest.mark.parametrize("n_sub,q,sqrt_k,n", [
    (2, 3, 5, 50), (6, 8, 16, 600), (4, 16, 32, 1024), (1, 1, 128, 100), (3, 37, 8, 1003),
])
def test_scscore_plain_matches_pallas_and_oracle(n_sub, q, sqrt_k, n):
    args = _scscore_case(np.random.default_rng(n_sub * 100 + q), n_sub, q, sqrt_k, n)
    jargs = [jnp.asarray(a) for a in args]
    want = np.asarray(jops.scscore(*jargs, impl="pallas"))
    np.testing.assert_array_equal(want, np.asarray(jref.scscore_ref(*jargs)))
    d1s, d2s, a1s, a2s, taus = (torch.from_numpy(a) for a in args)
    bits = collision_bits(collision_table(d1s, d2s, taus))
    cells = cell_ids(a1s, a2s, sqrt_k)
    np.testing.assert_array_equal(scscore_plain(bits, cells, q=q, block=64).numpy(), want)
    np.testing.assert_array_equal(ops.scscore(bits, cells, q=q).numpy(), want)
    np.testing.assert_array_equal(scoring.sc_scores(d1s, d2s, a1s, a2s, taus).numpy(), want)


def test_topk_smallest_breaks_ties_to_the_lowest_position():
    rng = np.random.default_rng(3)
    vals = rng.integers(0, 4, (9, 40)).astype(np.float32)
    vals[:, ::7] = np.inf
    for k in (1, 5, 40):
        gv, gp = topk_smallest(torch.from_numpy(vals), k)
        wv, wp = j_topk_smallest(jnp.asarray(vals), k)
        np.testing.assert_array_equal(gv.numpy(), np.asarray(wv))
        np.testing.assert_array_equal(gp.numpy(), np.asarray(wp))


CFG = dict(n_subspaces=3, subspace_dim=6, n_clusters=64, alpha=0.05, beta=0.02)


@pytest.fixture(scope="module")
def int_indexes():
    """The integer index of ``test_torch_query`` for each transform, built
    by ``repro`` and carried across."""
    rng = np.random.default_rng(11)
    data = rng.integers(-10, 11, (2000, 24)).astype(np.float32)
    queries = rng.integers(-10, 11, (12, 24)).astype(np.float32)
    out = {}
    for transform in ("entropy", "none"):
        ref = integer_valued(jtaco.build(data, J_ABLATIONS["taco"](**CFG, transform=transform)))
        port = taco.index_from_arrays(reference_arrays(ref), ref.sub_dims, device="cpu")
        out[transform] = (ref, port)
    return out, queries


def _assert_same(port_out, ref_out, keys=STATS):
    gi, gd, gs = port_out
    wi, wd, ws = ref_out
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
    np.testing.assert_array_equal(gd.numpy(), np.asarray(wd))
    for key in keys:
        np.testing.assert_array_equal(gs[key].numpy(), np.asarray(ws[key]), err_msg=key)
    for key in ("taus", "retrieved"):
        np.testing.assert_array_equal(gs[key].numpy().view(np.uint32),
                                      np.asarray(ws[key]).view(np.uint32), err_msg=key)


def _both(int_indexes, name, k, **kw):
    indexes, queries = int_indexes
    jcfg = J_ABLATIONS[name](**CFG, **kw)
    ref, port = indexes[jcfg.transform]
    want = jtaco.query_with_stats(ref, jnp.asarray(queries), jcfg, k=k)
    got = taco.query_with_stats(port, torch.from_numpy(queries), ABLATIONS[name](**CFG, **kw), k=k)
    return got, want


@pytest.mark.parametrize("precision", ["f32", "bf16"])
@pytest.mark.parametrize("selection", ["query_aware", "fixed"])
@pytest.mark.parametrize("k", [1, 10, 50, 100])
@pytest.mark.parametrize("transform", ["entropy", "none"])
def test_gather_bitwise_on_integer_index(int_indexes, transform, k, selection, precision):
    got, want = _both(int_indexes, "taco", k, transform=transform, selection=selection,
                      precision=precision)
    _assert_same(got, want)
    if k == 100 and selection == "query_aware":
        # k above the candidate count of some query: -1 / +inf slots
        assert (got[0].numpy() == -1).any() and np.isinf(got[1].numpy()).any()


@pytest.mark.parametrize("selection", ["query_aware", "fixed"])
@pytest.mark.parametrize("transform", ["entropy", "none"])
def test_gather_truncated_bitwise(int_indexes, transform, selection):
    """A candidate cap below the demand: the kept cap-subset (index order in
    query-aware mode, stable SC order in fixed mode) is the reference's."""
    got, want = _both(int_indexes, "taco", 10, transform=transform, selection=selection,
                      candidate_cap=12)
    _assert_same(got, want)
    assert got[2]["truncated"].any()
    assert (got[2]["candidate_count"] <= 12).all()


@pytest.mark.parametrize("activation", ["sort", "heap", "linear", "sort_lax"])
@pytest.mark.parametrize("name", sorted(ABLATIONS))
def test_ablation_configs_bitwise(int_indexes, name, activation):
    """Every configuration of config.py (and each activation under it)
    through both pipelines, with the kernels' route on the CPU."""
    for rerank in ("gather", "masked_full"):
        got, want = _both(int_indexes, name, 10, activation=activation, rerank=rerank,
                          use_kernels=True)
        keys = STATS if rerank == "gather" else STATS[1:]
        _assert_same(got, want, keys)


@pytest.mark.parametrize("selection", ["query_aware", "fixed"])
@pytest.mark.parametrize("transform", ["entropy", "none"])
def test_masked_equals_gather_when_not_truncated(int_indexes, transform, selection):
    """``tests/test_masked_rerank.py``'s masked ≡ gather, on the port: with
    cap = n nothing is truncated, so both pipelines find the same ids."""
    indexes, queries = int_indexes
    _ref, port = indexes[transform]
    cfg = taco_config(**CFG, transform=transform, selection=selection, candidate_cap=port.n)
    q = torch.from_numpy(queries)
    gi, gd, gs = taco.query_with_stats(port, q, cfg)
    assert not gs["truncated"].any()
    mi, md, ms = taco.query_with_stats(port, q, dataclasses.replace(cfg, rerank="masked_full"))
    if selection == "query_aware":
        np.testing.assert_array_equal(mi.numpy(), gi.numpy())
        np.testing.assert_allclose(md.numpy(), gd.numpy(), rtol=1e-6)
        np.testing.assert_array_equal(ms["candidate_demand"].numpy(),
                                      gs["candidate_demand"].numpy())
    else:
        # the masked pipeline re-ranks every tie at the threshold level, the
        # gather pipeline cuts them at the budget: a superset of candidates
        assert (ms["candidate_demand"] >= gs["candidate_demand"]).all()
        assert (md[:, 0] <= gd[:, 0]).all()
    np.testing.assert_array_equal(ms["sc_threshold"].numpy(), gs["sc_threshold"].numpy())


@pytest.fixture(scope="module")
def gmm_index():
    data0 = gmm_dataset(4096 + 16, 32, seed=3)
    data, queries = j_make_queries(data0, 16)
    cfg = dict(n_subspaces=4, subspace_dim=6, n_clusters=64, alpha=0.05, beta=0.02, k=10)
    ref = jtaco.build(data, J_ABLATIONS["taco"](**cfg))
    port = taco.index_from_arrays(reference_arrays(ref), ref.sub_dims, device="cpu")
    _gd, gt = exact_knn(data, queries, 10)
    return cfg, ref, port, queries, gt


@pytest.mark.parametrize("selection", ["query_aware", "fixed"])
def test_gmm_gather_recall_parity(gmm_index, selection):
    cfg, ref, port, queries, gt = gmm_index
    kw = dict(cfg, selection=selection)
    wi, _wd = jtaco.query(ref, jnp.asarray(queries), J_ABLATIONS["taco"](**kw))
    gi, _g = taco.query(port, torch.from_numpy(queries), taco_config(**kw))
    gi, wi = gi.numpy(), np.asarray(wi)
    assert np.mean(gi == wi) >= 0.99
    assert abs(recall_at_k(gi, gt, 10) - recall_at_k(wi, gt, 10)) <= 0.01


def test_default_config_searches_through_the_facade(gmm_index):
    """``AnnIndex.build(data, taco_config())`` + ``search``: the default
    gather re-rank, on a port-built index."""
    cfg, _ref, port, queries, gt = gmm_index
    index = AnnIndex.build(port.data, taco_config(**cfg), device="cpu")
    assert index.cfg.rerank == "gather"
    ids, dists, stats = index.search_with_stats(queries)
    assert ids.shape == (16, 10) and bool(np.isfinite(dists).all())
    assert stats["truncated"].dtype == np.bool_ and set(stats) == {"truncated", "candidate_count"}
    _i, _d, full = taco.query_with_stats(index.sc_index, torch.from_numpy(queries), index.cfg)
    assert full["sc"].shape == (16, 4096) and full["truncated"].dtype == torch.bool
    assert recall_at_k(ids, gt, 10) >= 0.5
