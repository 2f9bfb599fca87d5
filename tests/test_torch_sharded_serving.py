"""Sharded serving on the port: the cases of ``tests/test_sharded_serving.py``
run on ``repro_torch`` (CPU), through ``ShardedAnnBackend`` and
``serve_ann --shards``.

An integer-valued index built by ``repro`` is saved once; the reference's
sharded engine and launcher need 8 forced host devices, so they run on it
in one subprocess for the module (``XLA_FLAGS`` must be set before jax
starts), and the port loads the same save. On it the port's sharded engine
hands each request the reference sharded engine's ids and dists bit for bit
and the same per-shard telemetry, and equals the port's own single-device
engine per request, with k and beta overrides; ``serve_ann --shards 4``
matches the reference launcher's ``--shards 4`` (the launcher's queries are
float: ids of at least 95 % of the requests, as in
``tests/test_torch_serve_ann.py``) and the port's single-device launcher.
"""
import numpy as np
import pytest

from repro.ann import AnnIndex as JAnnIndex
from repro.core import taco as jtaco
from repro.core.config import taco_config as j_taco_config
from repro_torch.ann import AnnIndex, ShardedSearcher, SingleDeviceSearcher
from repro_torch.ann import searcher as searcher_mod
from repro_torch.launch import serve_ann
from repro_torch.serving import AnnRequest, AnnServingEngine, ShardedAnnBackend
from tests.test_torch_distributed import run_reference
from tests.test_torch_query import integer_valued
from tests.test_torch_serve_ann import CROSS_SHARE

#: tests/test_sharded_serving.py's config, on an integer corpus of half its
#: size: no query truncates on either placement, so the results are exact
CFG = dict(n_subspaces=4, subspace_dim=8, n_clusters=256, alpha=0.05, beta=0.02, k=10)
N, D, Q = 4096, 32, 16
#: the launcher's arguments, on the saved index; 40 requests in waves of 8
LAUNCH = ["--requests", "40", "--pressure", "8", "--mixed"]
SHARD_KEYS = ("shard_candidates_mean", "shard_truncation_rate", "combine_pairs_per_query")

REFERENCE = r"""
import json, sys
import numpy as np, jax
from repro.ann import AnnIndex
from repro.launch import serve_ann
from repro.serving import AnnRequest

index_dir, inputs, out = sys.argv[1:4]
assert len(jax.devices()) == 8, jax.devices()
index = AnnIndex.load(index_dir)
queries = np.load(inputs)["queries"]
res = {}
engine = index.engine("sharded", shards=8, max_batch=8)
reqs = [AnnRequest(query=q) for q in queries]
reqs[3] = AnnRequest(query=queries[3], k=5)
reqs[7] = AnnRequest(query=queries[7], beta=0.01)
for i, r in enumerate(engine.search(reqs)):
    res[f"engine/{i}/ids"], res[f"engine/{i}/dists"] = r.ids, r.dists
    res[f"engine/{i}/shard_candidates"] = r.shard_candidates
t = engine.telemetry()
res["telemetry"] = np.frombuffer(json.dumps(
    {k: t[k] for k in ("backend", "shards", "shard_candidates_mean",
                       "shard_truncation_rate", "combine_pairs_per_query")}).encode(), np.uint8)
for rerank in ("gather", "masked_full"):
    got = serve_ann.main(["--load-index", index_dir, "--shards", "4", "--rerank", rerank,
                          *sys.argv[4:]])
    for i, r in enumerate(got):
        res[f"launch/{rerank}/{i}"] = np.asarray(r.ids)
np.savez(out, **res)
print("REFERENCE_OK")
"""


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """(the saved index on the CPU in the port, queries, the reference's
    results, the save's path)."""
    import json

    tmp = tmp_path_factory.mktemp("sharded_serving")
    rng = np.random.default_rng(11)
    data = rng.integers(-10, 11, (N, D)).astype(np.float32)
    queries = rng.integers(-10, 11, (Q, D)).astype(np.float32)
    jcfg = j_taco_config(**CFG)
    path = str(tmp / "index")
    JAnnIndex(sc_index=integer_valued(jtaco.build(data, jcfg)), cfg=jcfg).save(path)
    np.savez(tmp / "inputs.npz", queries=queries)
    run_reference(REFERENCE, path, tmp / "inputs.npz", tmp / "ref.npz", *LAUNCH)
    ref = dict(np.load(tmp / "ref.npz"))
    ref["telemetry"] = json.loads(ref["telemetry"].tobytes())
    return AnnIndex.load(path, device="cpu"), queries, ref, path


def _requests(queries):
    reqs = [AnnRequest(query=q) for q in queries]
    reqs[3] = AnnRequest(query=queries[3], k=5)  # per-request k override
    reqs[7] = AnnRequest(query=queries[7], beta=0.01)  # per-request beta override
    return reqs


def _assert_same(got, want):
    for g, w in zip(got, want, strict=True):
        np.testing.assert_array_equal(g.ids, w.ids)
        np.testing.assert_array_equal(g.dists.view(np.uint32), w.dists.view(np.uint32))


@pytest.mark.parametrize("shards", [2, 4, 8])
def test_sharded_engine_equals_the_single_engine_per_request(served, shards):
    index, queries, _ref, _path = served
    single = index.engine(max_batch=8)
    sharded = index.engine("sharded", shards=shards, max_batch=8)
    assert isinstance(sharded.backend, ShardedAnnBackend)
    r_s, r_h = single.search(_requests(queries)), sharded.search(_requests(queries))
    assert not any(r.truncated for r in r_s + r_h)  # the exactness regime
    _assert_same(r_h, r_s)
    assert r_h[0].shard_candidates is not None and len(r_h[0].shard_candidates) == shards
    assert r_s[0].shard_candidates is None


def test_sharded_engine_and_telemetry_equal_the_references(served):
    index, queries, ref, _path = served
    engine = AnnServingEngine(index.sc_index, index.cfg, max_batch=8, backend="sharded",
                              shards=8)
    got = engine.search(_requests(queries))
    for i, r in enumerate(got):
        np.testing.assert_array_equal(r.ids, ref[f"engine/{i}/ids"])
        np.testing.assert_array_equal(r.dists.view(np.uint32),
                                      ref[f"engine/{i}/dists"].view(np.uint32))
        np.testing.assert_array_equal(r.shard_candidates, ref[f"engine/{i}/shard_candidates"])
    t = engine.telemetry()
    want = ref["telemetry"]
    assert t["backend"] == want["backend"] == "ShardedAnnBackend"
    assert t["shards"] == want["shards"] == 8
    for key in SHARD_KEYS:
        assert t[key] == want[key], key
    assert len(t["shard_candidates_mean"]) == 8
    assert 0 < t["combine_pairs_per_query"] <= 8 * 10
    # the function cache: the same groups again compile nothing new
    engine.search([AnnRequest(query=q) for q in queries[:8]])
    assert engine.telemetry()["compiles_total"] == t["compiles_total"]


def test_shard_candidates_sum_to_the_single_demand_and_large_k(served):
    index, queries, _ref, _path = served
    single = index.engine(max_batch=8)
    sharded = index.engine("sharded", shards=8, max_batch=8)
    _i, _d, stats = index.search_with_stats(queries)
    for r, want in zip(sharded.search([AnnRequest(query=q) for q in queries]),
                       stats["candidate_count"], strict=True):
        assert int(r.shard_candidates.sum()) == int(want)
    # the per-shard cap floors at the runtime k, so k = 150 > 4 beta n_local
    big = sharded.search([AnnRequest(query=queries[5], k=150)])[0]
    big_ref = single.search([AnnRequest(query=queries[5], k=150)])[0]
    np.testing.assert_array_equal(big.ids, big_ref.ids)
    with pytest.raises(ValueError, match="shard"):  # 513 > the 512-point shard
        sharded.search([AnnRequest(query=queries[0], k=513)])


def test_explicit_mesh_backend(served):
    index, queries, _ref, _path = served
    be = ShardedAnnBackend(index.sc_index, mesh=["cpu"] * 4, data_axes=("data",))
    assert be.shards == 4 and be.data_axes == ("data",) and be.query_axes == ()
    eng = AnnServingEngine(index.sc_index, index.cfg, max_batch=8, backend=be)
    want = index.engine(max_batch=8).search([AnnRequest(query=q) for q in queries[4:7]])
    _assert_same(eng.search([AnnRequest(query=q) for q in queries[4:7]]), want)
    searcher = index.searcher("sharded", mesh=["cpu", "cpu"])
    assert isinstance(AnnServingEngine(index.sc_index, index.cfg, backend=searcher).backend,
                      ShardedAnnBackend)
    with pytest.raises(ValueError, match="not both"):
        index.searcher("sharded", mesh=["cpu"] * 2, shards=2)
    with pytest.raises(NotImplementedError, match="query_axes"):
        index.searcher("sharded", shards=2, query_axes=("model",))
    with pytest.raises(NotImplementedError, match="data_axes"):
        index.searcher("sharded", shards=2, data_axes=("data", "model"))


def test_make_searcher_auto_rule(served, monkeypatch):
    index, _queries, _ref, _path = served
    assert isinstance(index.searcher(), SingleDeviceSearcher)  # one CPU device
    assert isinstance(index.searcher(shards=1), SingleDeviceSearcher)
    assert index.searcher(shards=4).shards == 4
    assert index.searcher(mesh=["cpu"] * 2).shards == 2
    with pytest.raises(ValueError, match="placement='sharded'"):
        index.searcher("single", shards=2)
    # several visible devices and an even split: sharded over all of them
    monkeypatch.setattr(searcher_mod, "_device_count", lambda _index: 4)
    auto = index.searcher()
    assert isinstance(auto, ShardedSearcher) and auto.shards == 4
    assert index.searcher("sharded").shards == 4
    monkeypatch.setattr(searcher_mod, "_device_count", lambda _index: 3)  # 2000 % 3
    assert isinstance(index.searcher(), SingleDeviceSearcher)


@pytest.mark.parametrize("rerank", ["gather", "masked_full"])
def test_serve_ann_shards_matches_the_reference_launcher(served, capsys, rerank):
    index, _queries, ref, path = served
    args = ["--device", "cpu", "--load-index", path, "--rerank", rerank, *LAUNCH]
    got = serve_ann.main([*args, "--shards", "4"])
    out = capsys.readouterr().out
    assert "[ShardedAnnBackend, 4 shard(s)]" in out and "per-shard candidates" in out
    assert len(got) == 40
    same = np.mean([np.array_equal(g.ids, ref[f"launch/{rerank}/{i}"])
                    for i, g in enumerate(got)])
    assert same >= CROSS_SHARE, same
    single = serve_ann.main(args)
    capsys.readouterr()
    # the launcher's float queries (beta x 2 on every third) truncate a few
    # gather queries on either placement
    exact = [i for i, (g, w) in enumerate(zip(got, single)) if not (g.truncated or w.truncated)]
    assert len(exact) >= 20, len(exact)
    _assert_same([got[i] for i in exact], [single[i] for i in exact])


def test_churn_with_shards_is_refused(capsys):
    with pytest.raises(SystemExit) as exc:
        serve_ann.main(["--device", "cpu", "--churn", "8", "--shards", "2"])
    assert exc.value.code == 2
    assert "single-device" in capsys.readouterr().err
