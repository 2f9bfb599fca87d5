"""The port's kernel autotuner (``repro_torch.kernels.autotune``) on the CPU:
the reference's cases of ``tests/test_autotune.py`` (cache semantics, the
search harness on the plain path, JSON persistence, the searcher and engine
warm-load, the ops consulting the cache, the CLI), plus the JSON files of
the two packages loading into each other, the reference's synthetic
problem drawn alike, and a candidate whose output differs from the
default's failing the search. Each search's budget is at most a second."""
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import autotune as jautotune
from repro.kernels import ref as jref
from repro_torch.kernels import autotune, ops
from repro_torch.kernels.masked_rerank import masked_rerank_plain
from repro_torch.kernels.schist import cell_ids, collision_bits, collision_table, schist_plain
from repro_torch.obs import metrics as obsm
from tests.test_torch_ref import _case, _t

DEFAULT = autotune.DEFAULT_BLOCKS


@pytest.fixture(autouse=True)
def _clean_cache():
    autotune.clear_cache()
    jautotune.clear_cache()
    yield
    autotune.clear_cache()
    jautotune.clear_cache()


def test_get_blocks_defaults_without_search():
    """A never-tuned key is a pure lookup miss: the op's default, and the
    cache stays empty (get never searches)."""
    assert autotune.get_blocks("schist", q=8, n=4096) == DEFAULT["schist"] == (256, 2048)
    assert autotune.get_blocks("masked_rerank", q=8, n=4096) == DEFAULT["masked_rerank"] \
        == (32, 4096)
    assert autotune._CACHE == {}


def test_set_get_roundtrip_and_shape_bucketing():
    autotune.set_blocks("masked_rerank", (16, 8192), q=16, n=100_000)
    # pow2 bucketing: nearby shapes share the winner...
    assert autotune.get_blocks("masked_rerank", q=10, n=70_000) == (16, 8192)
    # ...distant shapes do not
    assert autotune.get_blocks("masked_rerank", q=10, n=2048) == DEFAULT["masked_rerank"]
    # precision is part of the key
    assert autotune.get_blocks("masked_rerank", "bf16", q=16, n=100_000) == \
        DEFAULT["masked_rerank"]
    # so is the backend: a card's winner is not the plain path's
    assert autotune.get_blocks("masked_rerank", q=16, n=100_000, backend="cpu") == \
        DEFAULT["masked_rerank"]
    assert autotune.cache_key("schist", "f32", 1000, 10 ** 6, "cuda") == \
        ("schist", "cuda", "f32", 1024, 1 << 20)


def test_autotune_search_installs_winner():
    res = autotune.autotune("schist", q=8, n=512, budget_s=1.0, impl="torch", device="cpu")
    assert tuple(res["winner"]) == autotune.get_blocks("schist", q=8, n=512, backend="cpu")
    assert res["key"] == ["schist", "cpu", "f32", 8, 512]
    assert res["winner_us"] <= res["default_us"]
    assert res["trials"][0]["blocks"] == list(DEFAULT["schist"])
    assert 1 <= len(res["trials"]) <= len(autotune.CANDIDATES["schist"]) <= 8


def test_autotune_tiny_budget_still_yields_winner():
    """Budget exhausted after the default measurement: the default IS the
    winner; a deadline can never leave the cache without an entry."""
    res = autotune.autotune("masked_rerank", q=8, n=256, budget_s=0.0, impl="torch",
                            device="cpu")
    assert len(res["trials"]) == 1
    assert tuple(res["winner"]) == DEFAULT["masked_rerank"]
    assert autotune._CACHE == {("masked_rerank", "cpu", "f32", 8, 256): (32, 4096)}


def test_autotune_rejects_unknown_op():
    with pytest.raises(ValueError, match="unknown autotune op"):
        autotune.autotune("l2dist", device="cpu")


def test_autotune_raises_where_a_candidate_differs(monkeypatch):
    """A candidate's output must equal the default's bit for bit: a
    difference is a fault of the kernel, so the search raises and installs
    nothing."""
    real = ops.schist

    def skewed(*args, blocks=None, **kwargs):
        return real(*args, **kwargs) + int(tuple(blocks) != DEFAULT["schist"])

    monkeypatch.setattr(ops, "schist", skewed)
    with pytest.raises(RuntimeError, match="differs from the default"):
        autotune.autotune("schist", q=8, n=256, budget_s=1.0, impl="torch", device="cpu")
    assert autotune._CACHE == {}


def test_json_cache_roundtrip(tmp_path):
    autotune.set_blocks("schist", (128, 1024), q=16, n=8192, backend="cpu")
    autotune.set_blocks("masked_rerank", (16, 2048), "bf16", q=8, n=4096, backend="cuda")
    path = str(tmp_path / "blocks.json")
    autotune.save_cache(path)
    autotune.clear_cache()
    assert autotune._CACHE == {}
    assert autotune.load_cache(path) == 2
    assert autotune._CACHE[("schist", "cpu", "f32", 16, 8192)] == (128, 1024)
    assert autotune._CACHE[("masked_rerank", "cuda", "bf16", 8, 4096)] == (16, 2048)


def test_cache_files_cross_load_between_packages(tmp_path):
    """The reference's file loads into the port (its TPU key never reaches a
    call on the card) and the port's into the reference; the same entries
    give the same bytes."""
    jautotune.set_blocks("schist", (16, 1024), q=16, n=8192, backend="tpu")
    jautotune.set_blocks("masked_rerank", (32, 512), "bf16", q=8, n=4096, backend="cpu")
    ref_path = tmp_path / "ref.json"
    jautotune.save_cache(str(ref_path))
    assert autotune.load_cache(str(ref_path)) == 2
    assert autotune.get_blocks("schist", q=16, n=8192, backend="tpu") == (16, 1024)
    assert autotune.get_blocks("schist", q=16, n=8192, backend="cuda") == DEFAULT["schist"]
    assert autotune.get_blocks("masked_rerank", "bf16", q=8, n=4096, backend="cpu") == (32, 512)
    port_path = tmp_path / "port.json"
    autotune.save_cache(str(port_path))
    assert port_path.read_text() == ref_path.read_text()

    autotune.clear_cache()
    jautotune.clear_cache()
    autotune.set_blocks("masked_rerank", (16, 8192), q=1000, n=10 ** 6, backend="cuda")
    autotune.save_cache(str(port_path))
    assert jautotune.load_cache(str(port_path)) == 1
    assert jautotune._CACHE == {("masked_rerank", "cuda", "f32", 1024, 1 << 20): (16, 8192)}


def test_synthetic_problem_is_the_references():
    """The port's search inputs are the reference's draws from the seed,
    packed as the port's kernels take them."""
    shape = dict(q=8, n=300, d=16, n_sub=3, sqrt_k=8, k=5, seed=3)
    jargs, jkw = jautotune._synthetic_problem("masked_rerank", **shape)
    d1s, d2s, a1s, a2s, taus, thresh, data, norms, queries = (np.array(a) for a in jargs)
    args, kw = autotune.synthetic_problem("masked_rerank", **shape, device="cpu")
    bits, cells, t_thresh, t_data, t_norms, t_queries, k = args
    td1, td2, ttau, ta1, ta2 = _t(d1s, d2s, taus, a1s, a2s)
    assert torch.equal(bits, collision_bits(collision_table(td1, td2, ttau)))
    assert torch.equal(cells, cell_ids(ta1, ta2, 8))
    np.testing.assert_array_equal(t_thresh.numpy(), thresh)
    np.testing.assert_array_equal(t_data.numpy(), data)
    np.testing.assert_array_equal(t_queries.numpy(), queries)
    np.testing.assert_allclose(t_norms.numpy(), norms, rtol=1e-6)
    assert k == jkw["k"] == 5 and kw == {}
    sargs, skw = autotune.synthetic_problem("schist", **shape, device="cpu")
    assert torch.equal(sargs[0], bits) and torch.equal(sargs[1], cells)
    assert sargs[2] == 4 and skw == {"q": 8}


def test_searcher_and_engine_warm_load_cache(tmp_path):
    """Construction-time warm load: get_blocks serves the persisted winner
    without any search in this process, for the single-device and sharded
    searchers and the engine; the gauge and telemetry() count the entries."""
    from repro_torch.ann import AnnIndex
    from repro_torch.core.config import taco_config
    from repro_torch.serving import AnnRequest

    autotune.set_blocks("schist", (128, 1024), q=8, n=64, backend="cpu")
    autotune.set_blocks("masked_rerank", (16, 2048), q=8, n=64, backend="cpu")
    path = str(tmp_path / "blocks.json")
    autotune.save_cache(path)
    autotune.clear_cache()
    assert autotune.get_blocks("schist", q=8, n=64, backend="cpu") == DEFAULT["schist"]

    data = np.arange(64 * 16, dtype=np.float32).reshape(64, 16) % 7
    cfg = taco_config(k=4, n_subspaces=2, subspace_dim=8, n_clusters=16, kmeans_iters=2,
                      rerank="masked_full")
    index = AnnIndex.build(data, cfg, device="cpu")
    for placement, shards in (("single", None), ("sharded", 2)):
        autotune.clear_cache()
        s = index.searcher(placement, shards=shards, autotune_cache=path)
        assert s.autotune_entries_loaded == 2
        assert obsm.snapshot()["taco_searcher_autotune_entries_loaded"] == 2
        assert autotune.get_blocks("schist", q=8, n=64, backend="cpu") == (128, 1024)
        assert autotune.get_blocks("masked_rerank", q=8, n=64, backend="cpu") == (16, 2048)

    reqs = [AnnRequest(query=q) for q in data[:8]]
    autotune.clear_cache()
    plain = index.engine()
    assert plain.autotune_entries_loaded == 0
    assert "autotune_entries_loaded" not in plain.telemetry()
    want = plain.search(reqs)
    engine = index.engine(autotune_cache=path)
    assert engine.autotune_entries_loaded == 2
    assert autotune.get_blocks("masked_rerank", q=8, n=64, backend="cpu") == (16, 2048)
    got = engine.search(reqs)
    assert engine.telemetry()["autotune_entries_loaded"] == 2
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.ids, w.ids)
        np.testing.assert_array_equal(g.dists, w.dists)


def test_ops_consults_tuned_blocks(monkeypatch):
    """The ops hand the tuned (bq, bn) of the call's device type and shape
    to the kernel wrappers (spied on here, computing with the plain
    versions), an explicit ``blocks=`` overrides the cache, and the plain
    path's results stay bit for bit the reference's oracle under a
    non-default winner."""
    n_sub, q, sqrt_k, n, k = 3, 8, 16, 512, 10
    d1s, d2s, a1s, a2s, taus, thresh, data, norms, queries = _case(
        np.random.default_rng(21), n_sub, q, sqrt_k, n)
    td1, td2, ta1, ta2, ttau, tth, tdata, tnorms, tq = _t(
        d1s, d2s, a1s, a2s, taus, thresh, data, norms, queries)
    bits = collision_bits(collision_table(td1, td2, ttau))
    cells = cell_ids(ta1, ta2, sqrt_k)
    autotune.set_blocks("schist", (128, 1024), q=q, n=n, backend="cpu")
    autotune.set_blocks("masked_rerank", (16, 8192), q=q, n=n, backend="cpu")
    seen = {}

    def schist_spy(bits_, cells_, n_levels, *, q, blocks=None):
        seen["schist"] = blocks
        return schist_plain(bits_, cells_, n_levels, q=q)

    def rerank_spy(bits_, cells_, thresh_, queries_, data_, norms_, k_, exclude=None,
                   blocks=None):
        seen["masked_rerank"] = blocks
        return masked_rerank_plain(bits_, cells_, thresh_, queries_, data_, norms_, k_, exclude)

    monkeypatch.setattr(ops, "schist_cuda", schist_spy)
    monkeypatch.setattr(ops, "masked_rerank_cuda", rerank_spy)
    want_h = np.asarray(jref.schist_ref(*map(jnp.asarray, (d1s, d2s, a1s, a2s, taus)),
                                        n_sub + 1))
    wi, wd = (np.asarray(a) for a in jref.masked_rerank_ref(
        *map(jnp.asarray, (d1s, d2s, a1s, a2s, taus, thresh, queries, data, norms)), k))
    for impl in ("kernel", "torch"):
        got = ops.schist(bits, cells, n_sub + 1, q=q, impl=impl)
        np.testing.assert_array_equal(got.numpy(), want_h)
        gi, gd = ops.masked_rerank(bits, cells, tth, tdata, tnorms, tq, k, impl=impl)
        np.testing.assert_array_equal(gi.numpy(), wi)
        np.testing.assert_array_equal(gd.numpy(), wd)
        # the plain path neither looks up nor hands on blocks
        assert seen == {"schist": (128, 1024), "masked_rerank": (16, 8192)}
    ops.schist(bits, cells, n_sub + 1, q=q, impl="kernel", blocks=(64, 4096))
    ops.masked_rerank(bits, cells, tth, tdata, tnorms, tq, k, impl="kernel", precision="bf16")
    assert seen == {"schist": (64, 4096), "masked_rerank": DEFAULT["masked_rerank"]}


def test_cli_writes_json(tmp_path):
    path = str(tmp_path / "report.json")
    rc = autotune.main(["--ops", "schist", "masked_rerank", "--budget", "1", "--q", "4",
                        "--n", "256", "--impl", "torch", "--device", "cpu", "--json", path])
    assert rc == 0
    with open(path) as f:
        payload = json.load(f)
    assert [r["op"] for r in payload["results"]] == ["schist", "masked_rerank"]
    assert set(payload["cache"]) == {"schist|cpu|f32|4|256", "masked_rerank|cpu|f32|4|256"}
