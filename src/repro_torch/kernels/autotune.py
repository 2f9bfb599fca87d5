"""Autotuned (bq, bn) tiles for the streaming query kernels (mirrors
``repro.kernels.autotune``).

The ``schist`` and ``masked_rerank`` wrappers in
:mod:`repro_torch.kernels.ops` take their tiles from a two-level cache:

  * **in-process** — ``get_blocks(op, precision, q=, n=, backend=)`` is a
    dict lookup keyed by (op, backend, precision, pow2 bucket of Q, pow2
    bucket of n). It never searches: a key that was never tuned returns
    the op's :data:`DEFAULT_BLOCKS`. ``backend`` is the device type of the
    call (``"cuda"`` on the card, ``"cpu"`` for the plain path), passed by
    the caller, so an entry of another backend (the reference's ``"tpu"``)
    is never consulted for a call on the card.
  * **JSON** — ``save_cache`` / ``load_cache`` persist the winners in the
    reference's format (``"op|backend|prec|qb|nb": [bq, bn]``): either
    package loads a file the other wrote. Searchers, engines and
    ``serve_ann --autotune-cache`` load one once, at construction.

What (bq, bn) mean in the port's kernels (the geometry functions clamp them
as they clamp their own choice; a block's warps stay the most that fit):

  * ``masked_rerank``: bq is the queries a block of pass a (``lanes``, 32
    or 16; 16 above k = 512 whatever is asked), bn the points a chunk
    before the chunk count is capped
    (:func:`repro_torch.kernels.masked_rerank.rerank_geometry`);
  * ``schist``: bq is the queries a block (32 x its query tiles, 32 to
    256; no more tiles than the batch has or than fit), bn the points a
    work item of the persistent grid, rounded up to whole warp steps
    (:func:`repro_torch.kernels.schist.schist_geometry`, ``schist_chunk``).

Every (bq, bn) gives the same output bit for bit: the histogram counts
integers, and each (query, point) distance of ``masked_rerank`` is the same
float32 chain whatever block or chunk holds the pair, with ties broken by
the id. The plain path ignores the blocks.

``autotune()`` is the search harness: it times the candidate grid on the
reference's synthetic problem at the caller's shape, under a wall-clock
budget (a ``time.monotonic()`` deadline; the default blocks are timed first
so a winner always exists), checks every candidate's output against the
default's bit for bit, installs the winner in-process and returns the trial
table.

CLI (on the card; ``--device cpu --impl torch`` drives the harness on the
plain path)::

    PYTHONPATH=src python -m repro_torch.kernels.autotune --ops schist masked_rerank \\
        --budget 10 --q 1000 --n 1000000 --d 128 --k 10 --json winners.json
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from repro_torch.kernels import masked_rerank, schist

OPS = ("schist", "masked_rerank")

#: per op: the tiles a key that was never tuned gets (the kernels' own
#: geometry before there was a cache)
DEFAULT_BLOCKS: dict[str, tuple[int, int]] = {
    "schist": schist.DEFAULT_BLOCKS,
    "masked_rerank": masked_rerank.DEFAULT_BLOCKS,
}

#: per op: the (bq, bn) grid a search times, the default first. schist keeps
#: bq 256 and 128 at every bn (the tables of 8 or 4 tiles amortise the cell
#: ids' reads; 4 tiles let two blocks share an SM) and one 64-query point;
#: 32 queries a block read the cell ids eight times over.
CANDIDATES: dict[str, tuple[tuple[int, int], ...]] = {
    "masked_rerank": ((32, 4096), (32, 2048), (32, 8192), (32, 16384),
                      (16, 2048), (16, 4096), (16, 8192), (16, 16384)),
    "schist": ((256, 2048), (256, 1024), (256, 4096), (256, 8192),
               (128, 1024), (128, 2048), (128, 4096), (64, 2048)),
}

_CACHE: dict[tuple, tuple[int, int]] = {}


def _bucket(x: int) -> int:
    """Next power-of-two shape bucket (so nearby workloads share winners)."""
    x = max(int(x), 1)
    b = 1
    while b < x:
        b *= 2
    return b


def cache_key(op: str, precision: str = "f32", q: int = 8, n: int = 512,
              backend: str = "cuda") -> tuple:
    return (op, backend, precision, _bucket(q), _bucket(n))


def get_blocks(op: str, precision: str = "f32", q: int = 8, n: int = 512,
               backend: str = "cuda") -> tuple[int, int]:
    """Tuned (bq, bn) for this op and shape, or the op's
    :data:`DEFAULT_BLOCKS` where the key was never tuned. A pure lookup:
    it never searches."""
    return _CACHE.get(cache_key(op, precision, q, n, backend), DEFAULT_BLOCKS[op])


def set_blocks(op: str, blocks: tuple[int, int], precision: str = "f32",
               q: int = 8, n: int = 512, backend: str = "cuda") -> None:
    _CACHE[cache_key(op, precision, q, n, backend)] = (int(blocks[0]), int(blocks[1]))


def clear_cache() -> None:
    _CACHE.clear()


def _payload() -> dict:
    return {"|".join(str(p) for p in key): list(blocks) for key, blocks in _CACHE.items()}


# ------------------------------------------------------------- persistence --
def save_cache(path: str) -> None:
    """Persist the in-process winners as JSON ('op|backend|prec|qb|nb')."""
    with open(path, "w") as f:
        json.dump(_payload(), f, indent=2, sort_keys=True)


def load_cache(path: str) -> int:
    """Load winners saved by :func:`save_cache` (of either package); returns
    the entry count. The file is read and parsed before the cache changes,
    and the cache takes the entries in one update."""
    with open(path) as f:
        payload = json.load(f)
    entries = {}
    for key_str, blocks in payload.items():
        op, backend, precision, qb, nb = key_str.split("|")
        entries[(op, backend, precision, int(qb), int(nb))] = (int(blocks[0]), int(blocks[1]))
    _CACHE.update(entries)
    return len(payload)


# ------------------------------------------------------------------ search --
def synthetic_problem(op: str, q: int, n: int, d: int, n_sub: int, sqrt_k: int, k: int,
                      seed: int, device):
    """The reference's synthetic problem (``repro.kernels.autotune.
    _synthetic_problem``: the same numpy draws from ``seed``) as the port's
    inputs on ``device``: the packed collision bits and the cell ids, and
    for ``masked_rerank`` thresholds of N_s // 2, normal data and queries
    and the data's norms. Returns ``(args, kwargs)`` of the op in
    :mod:`repro_torch.kernels.ops`."""
    rng = np.random.default_rng(seed)

    def dev(a, dtype=torch.float32):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype).to(device)

    d1s = dev(rng.uniform(0, 4, (n_sub, q, sqrt_k)).astype(np.float32))
    d2s = dev(rng.uniform(0, 4, (n_sub, q, sqrt_k)).astype(np.float32))
    a1s = dev(rng.integers(0, sqrt_k, (n_sub, n)), torch.int32)
    a2s = dev(rng.integers(0, sqrt_k, (n_sub, n)), torch.int32)
    taus = dev(rng.uniform(2, 5, (n_sub, q)).astype(np.float32))
    bits = schist.collision_bits(schist.collision_table(d1s, d2s, taus))
    cells = schist.cell_ids(a1s, a2s, sqrt_k)
    if op == "schist":
        return (bits, cells, n_sub + 1), {"q": q}
    data = dev(rng.standard_normal((n, d)).astype(np.float32))
    queries = dev(rng.standard_normal((q, d)).astype(np.float32))
    norms = torch.sum(data * data, dim=1)
    thresh = torch.full((q,), n_sub // 2, dtype=torch.int32, device=device)
    return (bits, cells, thresh, data, norms, queries, k), {}


def _time_candidate(fn, sync, deadline: float, iters: int = 3):
    """``(output of the warm-up call, median elapsed us)`` over up to
    ``iters`` timed calls after it, each between two ``sync()``s, stopping
    early at the monotonic deadline."""
    out = fn()
    sync()
    ts = []
    for _ in range(iters):
        t0 = time.perf_counter()
        fn()
        sync()
        ts.append(time.perf_counter() - t0)
        if time.monotonic() >= deadline:
            break
    return out, float(np.median(ts) * 1e6)


def _same(a, b) -> bool:
    if isinstance(a, tuple):
        return all(torch.equal(x, y) for x, y in zip(a, b))
    return torch.equal(a, b)


def autotune(op: str = "masked_rerank", *, q: int = 16, n: int = 2048, d: int = 64,
             n_sub: int = 6, sqrt_k: int = 32, k: int = 10, budget_s: float = 10.0,
             impl: str = "kernel", precision: str = "f32", seed: int = 0,
             device="cuda") -> dict:
    """Search the candidate grid for ``op`` on a synthetic workload of this
    shape on ``device``; install and return the winner, keyed by the
    device's type (``schist`` as f32).

    The default blocks are timed first (a winner exists even on a zero
    budget); each further candidate is tried only while the monotonic
    deadline has not passed. Each candidate's output must equal the
    default's bit for bit, else this raises: a difference is a fault of the
    kernel. ``impl="torch"`` times the plain version, which ignores the
    blocks. Returns ``{"op", "key", "winner", "default_us", "winner_us",
    "trials": [{"blocks", "us"} ...]}``."""
    from repro_torch.kernels import ops
    from repro_torch.utils import resolve_device

    if op not in OPS:
        raise ValueError(f"unknown autotune op {op!r}")
    device = resolve_device(device)
    args, kwargs = synthetic_problem(op, q, n, d, n_sub, sqrt_k, k, seed, device)
    if op == "masked_rerank":
        kwargs["precision"] = precision
    key_precision = "f32" if op == "schist" else precision
    op_fn = getattr(ops, op)
    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)
    deadline = time.monotonic() + float(budget_s)

    default = DEFAULT_BLOCKS[op]
    grid = [default] + [c for c in CANDIDATES[op] if c != default]
    trials = []
    want = None
    for i, blocks in enumerate(grid):
        if i > 0 and time.monotonic() >= deadline:
            break
        out, us = _time_candidate(
            lambda: op_fn(*args, impl=impl, blocks=blocks, **kwargs), sync, deadline)
        if want is None:
            want = out
        elif not _same(out, want):
            raise RuntimeError(
                f"autotune: {op} at blocks {blocks} differs from the default blocks' output")
        trials.append({"blocks": list(blocks), "us": round(us, 1)})
    best = min(trials, key=lambda t: t["us"])
    winner = (best["blocks"][0], best["blocks"][1])
    set_blocks(op, winner, precision=key_precision, q=q, n=n, backend=device.type)
    return {
        "op": op,
        "key": list(cache_key(op, key_precision, q, n, device.type)),
        "winner": list(winner),
        "default_us": trials[0]["us"],
        "winner_us": best["us"],
        "trials": trials,
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ops", nargs="+", default=list(OPS))
    ap.add_argument("--budget", type=float, default=10.0,
                    help="wall-clock budget (s) PER op")
    ap.add_argument("--q", type=int, default=16)
    ap.add_argument("--n", type=int, default=2048)
    ap.add_argument("--d", type=int, default=64)
    ap.add_argument("--k", type=int, default=10)
    ap.add_argument("--impl", default="kernel", choices=["kernel", "torch", "auto"])
    ap.add_argument("--precision", default="f32", choices=["f32", "bf16"])
    ap.add_argument("--device", default="cuda",
                    help="the card (default) or 'cpu' for the plain path")
    ap.add_argument("--json", default=None, help="write trial table + cache")
    args = ap.parse_args(argv)

    results = []
    for op in args.ops:
        res = autotune(op, q=args.q, n=args.n, d=args.d, k=args.k, budget_s=args.budget,
                       impl=args.impl, precision=args.precision, device=args.device)
        results.append(res)
        print(f"{op}: winner bq,bn={tuple(res['winner'])} "
              f"({res['winner_us']:.1f} us vs default {res['default_us']:.1f} us, "
              f"{len(res['trials'])}/{len(CANDIDATES[op])} candidates tried)")
    if args.json:
        with open(args.json, "w") as f:
            json.dump({"results": results, "cache": _payload()}, f, indent=2)
        print(f"wrote {args.json}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
