"""ANN serving launcher: batched TaCo queries through the AnnIndex lifecycle,
on the card (mirrors ``repro.launch.serve_ann``).

Builds (or loads) a TaCo index through the :class:`repro_torch.ann.AnnIndex`
facade on ``--device`` (the card unless ``--device cpu`` is asked for; there
is no fallback), then serves a stream of requests in waves of
``--pressure`` concurrent requests through an
:class:`~repro_torch.serving.ann_engine.AnnServingEngine`. A fresh build's
config asks for the kernels (``use_kernels=True``), so on the card the
build and the queries run through the port's CUDA kernels. A loaded index
keeps the rest of its saved config, but on the card it too is served
through the kernels, whatever ``use_kernels`` it was saved with (the
reference's default saves it off, and the plain PyTorch path on the card is
tens of times slower); on the CPU the saved config stays as it is.

Index lifecycle: ``--save-index DIR`` persists the built index (atomic
npz + manifest, the reference's format); ``--load-index DIR`` starts the
server from a saved index *without rebuilding* (an index saved by either
package loads). ``--rerank`` selects the re-rank pipeline (the streaming
masked-full path vs the gather path); ``--result-cache N`` puts an N-entry
LRU result cache in front of the batch path. ``--mixed`` sprinkles
per-request k/beta overrides to exercise the grouping path. ``--churn M``
serves through a :class:`repro_torch.ann.MutableAnnIndex`: every wave
inserts M fresh vectors and deletes M//2 live ones between query batches,
compacting (and atomically swapping the engine's index) when the delta
grows past the policy threshold; ``--recall-probe-every N`` samples served
requests against exact kNN over the live corpus. ``--shards N`` serves
through the corpus-sharded backend: N shard views of the index, every one
on ``--device`` (one process, no device forcing: the reference's host
devices have no counterpart here).

Durability: ``--wal-dir DIR`` makes churn serving crash-safe — every
insert/delete batch is appended to a write-ahead log there *before* it is
applied (``--durability sync`` fsyncs on the caller's path, ``async``
group-commits on the shared worker pool). ``--save-index DIR`` with
``--churn`` persists the MUTABLE snapshot (base + delta + tombstones +
WAL watermark); a later ``--load-index DIR --wal-dir WAL`` replays the
log past the watermark, so a ``kill -9`` mid-churn loses nothing that
was acknowledged. ``--verify-recovery`` then proves it: the recovered
index is compacted and checked bitwise against a from-scratch build
over the recovered live corpus.

Async pipeline: ``--async`` starts the engine's background drain worker
and drives it with ``--producers`` concurrent submitter threads — each
``submit()`` returns an AnnFuture, batches form continuously off the
producers' threads. ``--deadline-ms`` attaches a per-request SLO (batches
close early as it nears; late results count as deadline misses),
``--max-queue-depth``/``--admission`` turn on admission control (requests
past the watermark are shed / served cache-only / degraded to a lower
beta). Combined with ``--churn`` the mutation waves — and their
policy-triggered compactions, tasks on the shared WorkerPool — run
concurrently with the producers across live engine swaps.

Kernel tiles: ``--autotune-cache PATH`` warm-loads (bq, bn) winners for
``schist`` and ``masked_rerank`` (a ``repro_torch.kernels.autotune``
``save_cache`` file, or the reference's) once, at engine construction; the
report then says how many entries were loaded. Tune on the card with
``python -m repro_torch.kernels.autotune``.

Examples:
  PYTHONPATH=src python -m repro_torch.launch.serve_ann --n 1000000 --d 128 \\
      --requests 1000 --pressure 64 --async --producers 4 --deadline-ms 50
  PYTHONPATH=src python -m repro_torch.launch.serve_ann --device cpu \\
      --n 4000 --requests 32 --pressure 8 --mixed --result-cache 64
  PYTHONPATH=src python -m repro_torch.launch.serve_ann --n 1000000 \\
      --d 128 --requests 256 --pressure 64 --shards 4
"""
from __future__ import annotations

import argparse
import dataclasses
import threading

import numpy as np

from repro_torch.ann import AnnIndex, CompactionPolicy, MutableAnnIndex
from repro_torch.ann.mutable import churn_wave
from repro_torch.ann.persistence import INDEX_STEP, MUTABLE_FORMAT
from repro_torch.checkpoint import read_manifest
from repro_torch.core.config import taco_config
from repro_torch.data import even_shard_total, gmm_dataset, make_queries
from repro_torch.obs import ObsServer
from repro_torch.obs import metrics as obsm
from repro_torch.obs import trace as obst
from repro_torch.serving import AdmissionError, AnnRequest
from repro_torch.utils import resolve_device


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=20000)
    ap.add_argument("--d", type=int, default=64)
    ap.add_argument("--k", type=int, default=None,
                    help="neighbors per request (default: 10 for a fresh "
                         "build; the saved config's k for --load-index)")
    ap.add_argument("--requests", type=int, default=64)
    ap.add_argument("--pressure", type=int, default=16,
                    help="concurrent requests per wave")
    ap.add_argument("--max-batch", type=int, default=64)
    ap.add_argument("--mixed", action="store_true",
                    help="vary k/beta across requests (exercises grouping)")
    ap.add_argument("--rerank", choices=["gather", "masked_full", "auto"],
                    default=None,
                    help="re-rank pipeline: Alg. 5 gather, the streaming "
                         "masked-full pass, or auto (masked single-device). "
                         "Default: gather for a fresh build; the saved "
                         "config for --load-index")
    ap.add_argument("--shards", type=int, default=0,
                    help="serve corpus-sharded in this many shards, all on "
                         "--device (0 = single-device backend)")
    ap.add_argument("--save-index", default=None, metavar="DIR",
                    help="persist the built index+config under DIR")
    ap.add_argument("--load-index", default=None, metavar="DIR",
                    help="serve a previously saved index (skips the build; "
                         "--n/--d are ignored, the saved config applies)")
    ap.add_argument("--result-cache", type=int, default=0, metavar="N",
                    help="LRU result cache entries in front of the batch "
                         "path (0 = off)")
    ap.add_argument("--churn", type=int, default=0, metavar="M",
                    help="serve through a MutableAnnIndex: per wave, insert "
                         "M fresh vectors and delete M//2 live ones between "
                         "query batches, with policy-driven compaction + "
                         "atomic engine swap (0 = immutable serving)")
    ap.add_argument("--recall-probe-every", type=int, default=0, metavar="N",
                    help="re-answer every Nth served request with exact kNN "
                         "over the live corpus; report live recall@k")
    ap.add_argument("--async", dest="async_mode", action="store_true",
                    help="serve through the background drain worker: "
                         "--producers threads submit concurrently, each "
                         "submit() returns an AnnFuture")
    ap.add_argument("--producers", type=int, default=4, metavar="P",
                    help="concurrent submitter threads for --async")
    ap.add_argument("--deadline-ms", type=float, default=0.0, metavar="MS",
                    help="per-request SLO: batches close early as it nears; "
                         "late results count as deadline misses (0 = none)")
    ap.add_argument("--max-queue-depth", type=int, default=0, metavar="N",
                    help="admission watermark: past N queued requests the "
                         "--admission policy applies (0 = unbounded)")
    ap.add_argument("--admission", choices=["reject", "cache_only", "degrade"],
                    default="reject",
                    help="what to do past --max-queue-depth: shed with "
                         "AdmissionError, serve cache hits only, or degrade "
                         "to a lower-beta fast path")
    ap.add_argument("--wal-dir", default=None, metavar="DIR",
                    help="write-ahead log directory: churn mutations are "
                         "logged there before they apply; with --load-index "
                         "the log is replayed past the snapshot watermark")
    ap.add_argument("--durability", choices=["none", "async", "sync"],
                    default=None,
                    help="WAL commit mode: sync fsyncs on the caller's "
                         "path, async group-commits on the worker pool "
                         "(default: sync when --wal-dir is given)")
    ap.add_argument("--autotune-cache", default=None, metavar="PATH",
                    help="warm-load kernel autotune winners (a "
                         "kernels.autotune save_cache JSON) at engine "
                         "construction")
    ap.add_argument("--verify-recovery", action="store_true",
                    help="after --load-index --wal-dir: compact the "
                         "recovered index and assert bitwise parity with a "
                         "from-scratch build over the recovered corpus")
    ap.add_argument("--metrics-port", type=int, default=None, metavar="N",
                    help="serve the live observability surface on this port "
                         "(0 = ephemeral): /metrics Prometheus text, "
                         "/telemetry JSON, /trace Chrome trace JSON")
    ap.add_argument("--trace-sample", type=float, default=0.0, metavar="R",
                    help="probability that a request/mutation starts a "
                         "trace (0 = tracing off, 1 = trace everything)")
    ap.add_argument("--trace-out", default=None, metavar="PATH",
                    help="dump the trace ring buffer as Chrome trace JSON "
                         "to PATH on exit (load in Perfetto / "
                         "chrome://tracing); implies --trace-sample 1.0 "
                         "unless one is given")
    ap.add_argument("--stats-every", type=int, default=0, metavar="N",
                    help="print a one-line engine stats summary every N "
                         "serving waves (0 = off)")
    ap.add_argument("--device", default="cuda",
                    help="where the index lives and the queries run: the "
                         "card (default) or 'cpu' for the plain PyTorch path")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if args.pressure < 1:
        ap.error("--pressure must be >= 1")
    if args.producers < 1:
        ap.error("--producers must be >= 1")
    if args.shards < 0:
        ap.error("--shards must be >= 0")
    if args.churn and args.shards > 1:
        ap.error("--churn serves single-device (sharded delta segments are "
                 "a ROADMAP follow-on)")
    if args.load_index and args.save_index:
        ap.error("--save-index with --load-index would rewrite the same "
                 "index; pick one")
    durability = args.durability
    if args.wal_dir and durability in (None, "none"):
        durability = "sync" if durability is None else ap.error(
            "--durability none contradicts --wal-dir")
    if durability in ("async", "sync") and not args.wal_dir:
        ap.error(f"--durability {durability} requires --wal-dir")
    if args.wal_dir and not (args.churn or args.load_index):
        ap.error("--wal-dir needs a mutable index: --churn or --load-index")
    if args.verify_recovery and not (args.load_index and args.wal_dir):
        ap.error("--verify-recovery needs --load-index and --wal-dir")
    if not 0.0 <= args.trace_sample <= 1.0:
        ap.error("--trace-sample must be in [0, 1]")
    if args.trace_out and args.trace_sample == 0.0:
        args.trace_sample = 1.0
    device = resolve_device(args.device)  # no card and no --device cpu: raise
    if args.trace_sample > 0.0:
        # install before any engine/pool exists so every span lands in one ring
        obst.set_default_tracer(obst.Tracer(sample_rate=args.trace_sample,
                                            seed=args.seed))

    held = max(args.requests, 1)
    mutable = None
    index = None
    if args.load_index:
        fmt = (read_manifest(args.load_index, INDEX_STEP).get("extra")
               or {}).get("format")
        if fmt == MUTABLE_FORMAT:
            policy = (CompactionPolicy(max_delta_rows=max(8, 4 * args.churn))
                      if args.churn else None)
            mutable = MutableAnnIndex.load(
                args.load_index, policy=policy, wal_dir=args.wal_dir,
                durability=durability, device=device,
            )
            replayed = (0 if mutable._wal is None
                        else mutable._wal.records_replayed)
            cfg = mutable.cfg = kernels_on_card(mutable.cfg, device)
            print(f"loaded mutable index from {args.load_index}: "
                  f"n_live={mutable.n_live} d={mutable.d} "
                  f"(replayed {replayed} WAL records, "
                  f"durability={mutable.durability})", flush=True)
            held_out = gmm_dataset(held, mutable.d, seed=args.seed + 1)
            if args.k is None:
                args.k = cfg.k
            if args.verify_recovery:
                _verify_recovery(mutable, args.seed)
        else:
            if args.wal_dir:
                ap.error(f"{args.load_index} is an immutable snapshot; "
                         "--wal-dir replay needs a mutable save "
                         "(serve_ann --churn --wal-dir --save-index)")
            index = AnnIndex.load(args.load_index, device=device)
            # only an EXPLICIT --rerank overrides the saved config
            if args.rerank is not None and args.rerank != index.cfg.rerank:
                index = index.replace_cfg(rerank=args.rerank)
            index = AnnIndex(sc_index=index.sc_index,
                             cfg=kernels_on_card(index.cfg, device))
            print(f"loaded index from {args.load_index}: n={index.n} "
                  f"d={index.d} ({index.index_bytes / 1e6:.1f} MB, "
                  f"rerank={index.cfg.rerank})", flush=True)
            # fresh query stream in the loaded index's space; an un-passed
            # --k defers to the saved config, like the rest of the loaded cfg
            held_out = gmm_dataset(held, index.d, seed=args.seed + 1)
            if args.k is None:
                args.k = index.cfg.k
    else:
        if args.k is None:
            args.k = 10
        n = even_shard_total(args.n, held, args.shards)
        data, held_out = make_queries(gmm_dataset(n, args.d, seed=args.seed), held)
        # use_kernels: on the card the build and every query run through the
        # port's CUDA kernels (on the CPU through their plain versions)
        cfg = taco_config(n_subspaces=6, subspace_dim=8, n_clusters=1024,
                          alpha=0.05, beta=0.02, k=args.k,
                          rerank=args.rerank or "gather", use_kernels=True)
        print(f"building TaCo index: n={data.shape[0]} d={args.d} "
              f"on {device} ...", flush=True)
        index = AnnIndex.build(data, cfg, device=device)
        if args.save_index and not args.churn:
            # with --churn the MUTABLE snapshot below supersedes this save
            index.save(args.save_index)
            print(f"saved index to {args.save_index} "
                  f"({index.index_bytes / 1e6:.1f} MB index "
                  f"+ {index.n * index.d * 4 / 1e6:.1f} MB data)", flush=True)

    pool = held_out
    if args.result_cache:
        # with the cache on, make hit traffic real: halve the distinct-query
        # pool so the measured stream itself repeats queries (the warm-up
        # overlap is dropped below, so hits can only come from in-stream
        # repeats — which is what the knob is meant to demonstrate)
        pool = held_out[: max(1, (held + 1) // 2)]
    base_cfg = mutable.cfg if mutable is not None else index.cfg
    reqs = []
    for i in range(args.requests):
        k = args.k
        beta = None
        if args.mixed and i % 3 == 1:
            k = max(1, args.k // 2)
        if args.mixed and i % 3 == 2:
            beta = base_cfg.beta * 2
        reqs.append(AnnRequest(query=pool[i % pool.shape[0]], k=k, beta=beta))

    serving_kwargs = dict(
        max_batch=args.max_batch,
        result_cache_size=args.result_cache,
        recall_probe_every=args.recall_probe_every,
        async_mode=args.async_mode,
        default_deadline_s=args.deadline_ms / 1e3 if args.deadline_ms else None,
        max_queue_depth=args.max_queue_depth,
        admission_policy=args.admission,
        autotune_cache=args.autotune_cache,
    )
    if mutable is None and args.churn:
        # compaction roughly every 4 churn waves; the swap is the point
        mutable = index.mutable(
            policy=CompactionPolicy(max_delta_rows=max(8, 4 * args.churn)),
            durability=durability or "none",
            wal_dir=args.wal_dir,
        )
        if args.save_index:
            # a MUTABLE snapshot: base + delta + tombstones + the WAL
            # watermark, so a restart replays only what came after it
            mutable.save(args.save_index)
            print(f"saved mutable snapshot to {args.save_index} "
                  f"(durability={mutable.durability})", flush=True)
    if mutable is not None:
        engine = mutable.engine(**serving_kwargs)
    else:
        placement = "sharded" if args.shards > 1 else "single"
        engine = index.engine(placement,
                              shards=args.shards if args.shards > 1 else None,
                              **serving_kwargs)
    # warm the steady-state query functions, then serve in waves; the
    # warm-up queries overlap the measured stream, so drop their cached
    # results to keep the printed latency/QPS about the backend, not cache
    # replay
    engine.search(reqs[: min(args.pressure, len(reqs))])
    engine.reset_telemetry()
    engine.clear_result_cache()
    churn_rng = np.random.default_rng(args.seed + 7)
    inserted: list[int] = []
    results = []
    obs_server = None
    if args.metrics_port is not None:
        obs_server = ObsServer(port=args.metrics_port, telemetry_fn=engine.telemetry)
        print(f"observability: {obs_server.url}/metrics  /telemetry  /trace",
              flush=True)
    try:
        return _serve(args, engine, mutable, reqs, results, inserted, churn_rng)
    finally:
        # abnormal exits must not strand the WAL with unflushed appends
        # (or leave the engine's drain worker running)
        engine.close()
        if mutable is not None:
            mutable.close()
        if obs_server is not None:
            obs_server.close()
        if args.trace_out:
            n = obst.default_tracer().dump_chrome(args.trace_out)
            print(f"wrote {n} trace spans to {args.trace_out} "
                  "(load in Perfetto or chrome://tracing)", flush=True)


def kernels_on_card(cfg, device):
    """The config a loaded index is served with: on the card ``use_kernels``
    is switched on (a save made with the default config has it off, and
    would run the plain PyTorch path there; the kernels take every shape the
    reference takes, so no config stays off them); on the CPU, where the
    kernels' wrappers run their plain versions anyway, the saved config
    stays."""
    if device.type == "cpu" or cfg.use_kernels:
        return cfg
    print(f"serving on {device} through the CUDA kernels "
          "(the saved config has use_kernels off)", flush=True)
    return dataclasses.replace(cfg, use_kernels=True)


def _verify_recovery(mutable, seed):
    """``--verify-recovery``: prove the replayed state is coherent against
    a from-scratch ``AnnIndex.build`` over the recovered live corpus.

    Pre-compaction the recovered base+delta and the oracle run different
    clusterings, so approximate selection can only be held to a recall
    floor; ``compact()`` then installs exactly the oracle build, after
    which results must match the oracle bitwise."""
    rng = np.random.default_rng(seed + 13)
    queries = rng.standard_normal((8, mutable.d)).astype(np.float32)
    oracle, id_map = mutable.rebuild_oracle()
    want_i, want_d = oracle.search(queries)
    want_ext = np.where(want_i >= 0, id_map[np.maximum(want_i, 0)], -1)

    got_i, _ = mutable.search(queries)
    overlap = float(np.mean([
        len(set(g[g >= 0]) & set(w[w >= 0])) / max(1, int(np.sum(w >= 0)))
        for g, w in zip(got_i, want_ext)
    ]))
    mutable.compact(reason="verify-recovery")
    post_i, post_d = mutable.search(queries)
    bitwise = np.array_equal(post_i, want_ext) and np.array_equal(post_d, want_d)
    print(f"verify-recovery: pre-compaction overlap vs oracle {overlap:.2f}, "
          f"post-compaction bitwise {'MATCH' if bitwise else 'MISMATCH'}",
          flush=True)
    if not bitwise or overlap < 0.1:
        # the overlap floor is a sanity check (replayed state is not
        # garbage), not a recall target: the two sides run different
        # clusterings, so approximate selection legitimately diverges
        snap = {k: v for k, v in sorted(obsm.snapshot().items())
                if k.startswith(("taco_wal_", "taco_mutable_",
                                 "taco_compaction_"))}
        print("verify-recovery metric snapshot (WAL/mutable/compaction "
              "state at failure):", flush=True)
        for key, val in snap.items():
            print(f"  {key} = {val}", flush=True)
        raise SystemExit("verify-recovery FAILED: recovered index does not "
                         "match the from-scratch oracle")


def _stats_line(engine, wave):
    """One-line periodic serving summary (``--stats-every``)."""
    t = engine.telemetry()
    return (f"  [wave {wave}] served {t['requests_served']} "
            f"in {t['batches']} batches   "
            f"p50 {t['latency_p50_s'] * 1e3:.2f} ms "
            f"p99 {t['latency_p99_s'] * 1e3:.2f} ms   "
            f"{t['queries_per_sec']:.0f} q/s   "
            f"queue {t['queue_depth']} (peak {t['queue_depth_peak']})   "
            f"cache hits {t['result_cache_hits']}")


def _serve(args, engine, mutable, reqs, results, inserted, churn_rng):
    shed = 0
    if args.async_mode:
        # concurrent producers drive the background drain worker; churn
        # waves (and their pool-hosted compactions) run alongside them
        n_p = min(args.producers, max(1, len(reqs)))
        slices = [reqs[i::n_p] for i in range(n_p)]
        out: list = [None] * n_p
        shed_counts = [0] * n_p

        def producer(i: int) -> None:
            futures = []
            for r in slices[i]:
                try:
                    futures.append(engine.submit(r))
                except AdmissionError:
                    shed_counts[i] += 1
            out[i] = [f.result(timeout=120.0) for f in futures]

        threads = [threading.Thread(target=producer, args=(i,), daemon=True)
                   for i in range(n_p)]
        stop_stats = threading.Event()
        if args.stats_every:
            # async serving has no caller-side waves; report every time the
            # engine finishes another --stats-every waves' worth of requests
            def stats_monitor():
                reported = 0
                while not stop_stats.wait(0.25):
                    wave = engine.telemetry()["requests_served"] // args.pressure
                    if wave >= reported + args.stats_every:
                        reported = wave
                        print(_stats_line(engine, wave), flush=True)

            threading.Thread(target=stats_monitor, name="serve-ann-stats",
                             daemon=True).start()
        for th in threads:
            th.start()
        if mutable is not None and args.churn:
            for _ in range(max(1, len(reqs) // args.pressure)):
                handle = churn_wave(mutable, churn_rng, inserted, args.churn,
                                    engine=engine, background=True)
                if handle is not None:
                    handle.result(timeout=300.0)  # pool task, not this thread
        for th in threads:
            th.join()
        stop_stats.set()
        for chunk in out:
            results.extend(chunk)
        shed = sum(shed_counts)
        engine.close()
    else:
        for wave, lo in enumerate(range(0, len(reqs), args.pressure), 1):
            if mutable is not None and args.churn:
                # mixed workload: mutate between query waves, compact on
                # policy
                churn_wave(mutable, churn_rng, inserted, args.churn, engine=engine)
            results.extend(engine.search(reqs[lo : lo + args.pressure]))
            if args.stats_every and wave % args.stats_every == 0:
                print(_stats_line(engine, wave), flush=True)

    t = engine.telemetry()
    print(f"served {len(results)} requests in {t['batches']} batches "
          f"[{t['backend']}, {t['shards']} shard(s)]")
    print(f"  p50 latency {t['latency_p50_s'] * 1e3:.2f} ms   "
          f"p99 {t['latency_p99_s'] * 1e3:.2f} ms   "
          f"{t['queries_per_sec']:.0f} queries/s")
    print(f"  truncation rate {t['truncation_rate']:.3f}   "
          f"compiles {t['compiles_total']} {t['compiles_per_bucket']}")
    if "autotune_entries_loaded" in t:
        print(f"  autotune: {t['autotune_entries_loaded']} (bq, bn) entries "
              f"warm-loaded from {args.autotune_cache}")
    if args.async_mode:
        print(f"  async: {args.producers} producers   "
              f"queue peak {t['queue_depth_peak']}   "
              f"early closes {t['batches_closed_early']}   "
              f"deadline misses {t['deadline_misses']}")
        if args.max_queue_depth:
            print(f"  admission[{args.admission}]: shed {t['shed']}   "
                  f"degraded {t['degraded']}   "
                  f"cache-only served {t['cache_only_served']}")
            if shed != t["shed"]:
                print(f"  WARNING: producers saw {shed} AdmissionErrors but "
                      f"telemetry counted {t['shed']}")
    if args.result_cache:
        print(f"  result cache: {t['result_cache_hits']} hits / "
              f"{t['result_cache_misses']} misses "
              f"({t['result_cache_entries']} entries, "
              f"{t['result_cache_invalidations']} invalidations)")
    if args.recall_probe_every:
        recall = t["live_recall_at_k"]
        print(f"  live recall@k {recall if recall is None else f'{recall:.4f}'}"
              f" over {t['recall_probe_count']} probes "
              f"({t['recall_probe_skipped']} skipped: stale generation)")
    if mutable is not None:
        ms = t["mutable"]
        print(f"  mutable: {ms['n_live']} live ({ms['n_delta_live']} delta, "
              f"{ms['n_tombstones']} tombstones), "
              f"{ms['compactions']} compactions "
              f"(last {0 if ms['last_compaction_s'] is None else ms['last_compaction_s'] * 1e3:.0f} ms), "
              f"generation {t['index_generation']}, "
              f"{t['index_swaps']} engine swaps")
    if "wal" in t:
        w = t["wal"]
        print(f"  wal: {w['appends']} appends   {w['fsyncs']} fsyncs   "
              f"group mean {w['mean_group']:.1f} max {w['max_group']}   "
              f"{w['bytes_appended']} bytes   "
              f"segment {w['segment']} ({w['segments_retired']} retired)   "
              f"replayed {w['records_replayed']}")
    if t["shards"] > 1:
        mean_c = ", ".join(f"{c:.0f}" for c in t["shard_candidates_mean"])
        print(f"  per-shard candidates/query [{mean_c}]   "
              f"combine {t['combine_pairs_per_query']:.0f} id/dist pairs/query   "
              f"shard trunc max {max(t['shard_truncation_rate']):.3f}")
    for i, r in enumerate(results[:4]):
        print(f"  req{i}: ids[:5]={r.ids[:5].tolist()} "
              f"d[:3]={np.round(r.dists[:3], 4).tolist()}")
    return results


if __name__ == "__main__":
    main()
