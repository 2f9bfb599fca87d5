"""``python -m repro_torch.launch.serve_ann`` on the CPU (``--device cpu``):
its returned results equal the port's engine over the same index and
request stream bit for bit (sync, ``--async``, ``--mixed
--result-cache``); a churned, WAL-logged save recovers with
``--verify-recovery`` printing MATCH; on an integer-valued index saved by
``repro`` its ids equal the reference launcher's under the same arguments
for at least 95 % of the requests (the queries are float, so sums in
another order may flip a near-tie); ``--shards 2`` serves the
single-device results through the sharded backend; ``--autotune-cache``
warm-loads a winner table and serves the same results; what is not ported
is refused."""
import dataclasses

import numpy as np
import pytest
import torch

from repro.ann import AnnIndex as JAnnIndex
from repro.core import taco as jtaco
from repro.core.config import taco_config as j_taco_config
from repro.launch import serve_ann as j_serve_ann
from repro_torch.ann import AnnIndex
from repro_torch.core.config import taco_config
from repro_torch.data import gmm_dataset, make_queries
from repro_torch.launch import serve_ann
from repro_torch.serving import AnnRequest
from tests.test_torch_query import integer_valued

N, D = 3000, 64
#: the share of requests whose ids must equal the reference launcher's
CROSS_SHARE = 0.95


def _run(*args):
    return serve_ann.main(["--device", "cpu", *map(str, args)])


def _stream(index, n_requests, *, mixed=False, seed=0, cache=False):
    """The launcher's request stream for a fresh build at ``N``/``D``."""
    held = max(n_requests, 1)
    _data, held_out = make_queries(gmm_dataset(N, D, seed=seed), held)
    pool = held_out[: max(1, (held + 1) // 2)] if cache else held_out
    out = []
    for i in range(n_requests):
        k, beta = 10, None
        if mixed and i % 3 == 1:
            k = 5
        if mixed and i % 3 == 2:
            beta = index.cfg.beta * 2
        out.append(AnnRequest(query=pool[i % pool.shape[0]], k=k, beta=beta))
    return out


def _in_waves(engine, reqs, pressure):
    """The launcher's synchronous serve: a warm-up wave whose cached results
    are dropped, then waves of ``pressure`` requests. The waves fix every
    batch's bucket, and a gather batch of one query may differ from a wider
    one in the last bit of a float distance."""
    engine.search(reqs[:pressure])
    engine.reset_telemetry()
    engine.clear_result_cache()
    return [r for lo in range(0, len(reqs), pressure)
            for r in engine.search(reqs[lo:lo + pressure])]


def _assert_bitwise(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.ids, w.ids)
        np.testing.assert_array_equal(g.dists.view(np.uint32), w.dists.view(np.uint32))


@pytest.mark.parametrize("extra", [[], ["--mixed", "--result-cache", "64"],
                                   ["--rerank", "masked_full", "--recall-probe-every", "4"]],
                         ids=["plain", "mixed-cache", "masked-probes"])
def test_sync_results_equal_the_engine_bitwise(tmp_path, capsys, extra):
    path = tmp_path / "idx"
    results = _run("--n", N, "--d", D, "--requests", 24, "--pressure", 8,
                   "--save-index", path, *extra)
    out = capsys.readouterr().out
    assert "served 24 requests" in out
    index = AnnIndex.load(str(path), device="cpu")  # the saved cfg has --rerank
    reqs = _stream(index, 24, mixed="--mixed" in extra, cache="--result-cache" in extra)
    want = _in_waves(index.engine(max_batch=64, result_cache_size=64), reqs, 8)
    _assert_bitwise(results, want)
    if "--recall-probe-every" in extra:
        assert "live recall@k" in out and "over 6 probes" in out


def test_async_results_equal_the_engine_bitwise(tmp_path, capsys):
    """Masked-full, whose float results do not depend on how the drain
    worker happened to batch them."""
    path = tmp_path / "idx"
    results = _run("--n", N, "--d", D, "--requests", 30, "--pressure", 8, "--async",
                   "--producers", 3, "--deadline-ms", 500, "--rerank", "masked_full",
                   "--save-index", path)
    assert "served 30 requests" in capsys.readouterr().out
    index = AnnIndex.load(str(path), device="cpu")
    assert index.cfg.rerank == "masked_full"
    reqs = _stream(index, 30)
    # the producers' results come back producer by producer
    order = [j for p in range(3) for j in range(30)[p::3]]
    want = index.engine(max_batch=64).search([reqs[j] for j in order])
    _assert_bitwise(results, want)


def test_churn_with_wal_then_verify_recovery(tmp_path, capsys):
    idx, wal = tmp_path / "idx", tmp_path / "wal"
    results = _run("--n", N, "--d", D, "--requests", 32, "--pressure", 8, "--churn", 16,
                   "--wal-dir", wal, "--durability", "async", "--save-index", idx,
                   "--rerank", "masked_full", "--recall-probe-every", 5, "--async",
                   "--producers", 2, "--stats-every", 1)
    out = capsys.readouterr().out
    assert "served 32 requests" in out and "engine swaps" in out and "wal:" in out
    assert len(results) == 32 and all(r.ids.shape == (10,) for r in results)
    results = _run("--load-index", idx, "--wal-dir", wal, "--verify-recovery",
                   "--requests", 8, "--pressure", 4)
    out = capsys.readouterr().out
    assert "post-compaction bitwise MATCH" in out and "served 8 requests" in out
    assert len(results) == 8


def test_autotune_cache_warm_loads_and_serves_the_same_results(tmp_path, capsys):
    """``--autotune-cache`` loads a saved (bq, bn) table at engine
    construction and says so in its report; the results equal a run without
    it bit for bit (the plain path ignores the tiles, and on the card every
    tile gives the same answer)."""
    from repro_torch.kernels import autotune

    autotune.clear_cache()
    autotune.set_blocks("schist", (128, 1024), q=8, n=N, backend="cpu")
    autotune.set_blocks("masked_rerank", (16, 8192), q=8, n=N, backend="cpu")
    winners = tmp_path / "winners.json"
    autotune.save_cache(str(winners))
    autotune.clear_cache()
    args = ["--n", N, "--d", D, "--requests", 16, "--pressure", 8, "--rerank", "masked_full"]
    try:
        tuned = _run(*args, "--autotune-cache", winners)
        out = capsys.readouterr().out
        assert "served 16 requests" in out
        assert f"autotune: 2 (bq, bn) entries warm-loaded from {winners}" in out
        assert autotune.get_blocks("schist", q=8, n=N, backend="cpu") == (128, 1024)
        autotune.clear_cache()
        plain = _run(*args)
        assert "autotune:" not in capsys.readouterr().out
    finally:
        autotune.clear_cache()
    _assert_bitwise(tuned, plain)


def test_load_of_a_reference_save_equals_the_reference_launcher(tmp_path, capsys):
    rng = np.random.default_rng(3)
    data = rng.integers(-10, 11, (3000, 32)).astype(np.float32)
    jcfg = j_taco_config(n_subspaces=3, subspace_dim=8, n_clusters=64, alpha=0.05,
                         beta=0.02, k=10)
    path = str(tmp_path / "ref")
    JAnnIndex(sc_index=integer_valued(jtaco.build(data, jcfg)), cfg=jcfg).save(path)
    args = ["--load-index", path, "--requests", 40, "--pressure", 8, "--mixed"]
    for rerank in ("gather", "masked_full"):
        want = j_serve_ann.main([str(a) for a in args + ["--rerank", rerank]])
        got = _run(*args, "--rerank", rerank)
        assert len(got) == len(want) == 40
        same = np.mean([np.array_equal(g.ids, np.asarray(w.ids)) for g, w in zip(got, want)])
        assert same >= CROSS_SHARE, (rerank, same)
    capsys.readouterr()


def test_kernels_on_card_switches_use_kernels_on_for_the_card_only(capsys):
    cfg = taco_config(n_subspaces=3, subspace_dim=8, n_clusters=64)
    assert not cfg.use_kernels  # the default config, as the reference saves it
    assert serve_ann.kernels_on_card(cfg, torch.device("cpu")) is cfg
    on = serve_ann.kernels_on_card(cfg, torch.device("cuda"))
    assert on == dataclasses.replace(cfg, use_kernels=True)
    assert "through the CUDA kernels" in capsys.readouterr().out
    kernels = serve_ann.kernels_on_card(on, torch.device("cuda"))
    assert kernels is on and capsys.readouterr().out == ""


@pytest.mark.parametrize("rerank", ["masked_full", "auto"])
def test_kernels_on_card_keeps_the_plain_path_where_a_kernel_refuses(capsys, rerank):
    """No kernel refuses a config any more, so no loaded config keeps the
    plain path on the card: a masked-full config at k = 2000 (past the 1024
    masked_rerank once took), at N_s = 17 (past the 16 of the collision
    kernels) and at a 20 x 4096 table (past shared memory) is switched onto
    the kernels, with no plain route printed, and so is the gather
    pipeline. The device is only named: no card is needed."""
    cases = [dict(n_subspaces=6, n_clusters=1024, k=2000),
             dict(n_subspaces=17, n_clusters=1024, k=10),
             dict(n_subspaces=20, n_clusters=4096, k=10)]
    for case in cases:
        cfg = taco_config(subspace_dim=8, rerank=rerank, **case)
        for c in (cfg, dataclasses.replace(cfg, rerank="gather")):
            got = serve_ann.kernels_on_card(c, torch.device("cuda"))
            out = capsys.readouterr().out
            assert got == dataclasses.replace(c, use_kernels=True)
            assert "through the CUDA kernels" in out and "plain PyTorch path" not in out
    assert not hasattr(serve_ann, "kernel_refusal")


@pytest.mark.parametrize("mutable", [False, True], ids=["immutable", "mutable"])
def test_a_loaded_default_config_save_is_served_with_the_kernels(tmp_path, capsys,
                                                                   monkeypatch, mutable):
    """Both ``--load-index`` branches hand the saved config to
    ``kernels_on_card`` and serve with what it returns. Here it is told the
    device is the card, so the CPU index is served with ``use_kernels`` on
    (the kernels' wrappers run their plain versions on CPU tensors)."""
    data, _ = make_queries(gmm_dataset(2000, 32, seed=4), 8)
    cfg = taco_config(n_subspaces=3, subspace_dim=8, n_clusters=64, alpha=0.05,
                      beta=0.02, k=10)
    index = AnnIndex.build(data, cfg, device="cpu")
    path = str(tmp_path / "idx")
    index.mutable().save(path) if mutable else index.save(path)
    seen = []

    def on_card(c, device):
        assert device.type == "cpu"
        seen.append(serve_ann.kernels_on_card.__wrapped__(c, torch.device("cuda")))
        return seen[-1]

    on_card.__wrapped__ = serve_ann.kernels_on_card
    monkeypatch.setattr(serve_ann, "kernels_on_card", on_card)
    results = _run("--load-index", path, "--requests", 12, "--pressure", 4)
    assert len(seen) == 1 and seen[0].use_kernels and not cfg.use_kernels
    assert "served 12 requests" in capsys.readouterr().out
    if not mutable:  # the launcher's stream for a loaded index, in its waves
        want = AnnIndex(sc_index=index.sc_index, cfg=seen[0])
        reqs = [AnnRequest(query=q, k=10) for q in gmm_dataset(12, 32, seed=1)]
        _assert_bitwise(results, _in_waves(want.engine(max_batch=64), reqs, 4))


@pytest.mark.parametrize("args, match", [
    (["--churn", "8", "--shards", "2"], "single-device"),
    (["--verify-recovery"], "needs --load-index and --wal-dir"),
    (["--durability", "sync"], "requires --wal-dir"),
    (["--load-index", "a", "--save-index", "b"], "pick one"),
])
def test_refused_arguments(capsys, args, match):
    with pytest.raises(SystemExit) as exc:
        _run(*args)
    assert exc.value.code == 2
    assert match in capsys.readouterr().err


def test_shards_serve_through_the_sharded_engine(tmp_path, capsys):
    """``--shards 2`` answers through the corpus-sharded backend, with the
    single-device launcher's results (masked-full never truncates, so bit
    for bit)."""
    args = ["--n", N, "--d", D, "--requests", 16, "--pressure", 8, "--rerank", "masked_full"]
    got = _run(*args, "--shards", 2)
    out = capsys.readouterr().out
    assert "served 16 requests" in out and "[ShardedAnnBackend, 2 shard(s)]" in out
    assert "per-shard candidates/query" in out
    _assert_bitwise(got, _run(*args))


def test_no_card_and_no_cpu_request_fails():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is usable")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve_ann.main(["--n", "100", "--requests", "2"])
