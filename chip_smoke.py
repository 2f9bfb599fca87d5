#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of TaCo on one NVIDIA card.

    python3 chip_smoke.py            # full size: 10^6 x 128 corpus, 1000 queries

Phases, in order; any failure exits nonzero:
  1. device  — require CUDA, print the card's name and power limit;
  2. build   — compile the six kernels (one nvcc per source, in parallel);
  3. kernels — hold each ANN kernel against its plain PyTorch version on the
               card at the main path's shapes and at a ragged shape, on
               integer inputs (bitwise) and float inputs (stated tolerances),
               and time kernel, plain version and one library call beside the
               bound; the batched l2dist (a batch's 12 (subspace, half)
               pairs in one launch) must equal one single-pair launch per
               pair bit for bit on float inputs, and is timed beside those
               12 launches; so is the batched kmeans_assign (a build's 12
               pairs in one launch) at TaCo's halves of 4 and SuCo's of
               10/11, 11/12 padded to 12, also bitwise against its plain
               version on integer inputs; schist is also held against its
               plain version on the card tests' shapes, and its launch
               geometry (tiles a block) is kept in chip_smoke.json;
               masked_rerank's launch geometry and resident warps per SM
               are printed at k = 10 and 100, and its ptxas report (kept in
               chip_smoke.json) must show no spills;
  4. flash   — ops.flash_attention at the attention widths of granite-3-2b
               (32 heads of 64, causal, bf16 and f32) and qwen1.5-4b (20
               heads of 128, causal, bf16 and f32), S = T = 4096, plus a
               ragged non-causal case; each held against the plain version
               (bf16 also against the plain version in f32) and timed beside
               its bound and scaled_dot_product_attention; the kernel's
               ptxas report (kept in chip_smoke.json) must show no spills;
  5. masked  — build a TaCo index over a SIFT1M-shaped corpus on the card with
               use_kernels=True (its k-means in lockstep over all 12 (subspace,
               half) pairs) under torch.profiler (host clock, device busy
               time, top device and host operations), time one more build
               without it, and answer 1000 queries (padded to the 1024
               bucket by the searcher) at k = 10 and 100 in both selection
               modes with rerank="masked_full"; recall@10 is checked against
               brute force and against the plain path on the same index; a
               SuCo index over an integer-valued 10^5 x 128 corpus must equal
               one k-means per (subspace, half) on the card bit for bit;
  6. gather  — the same index with the default rerank="gather" at k = 10 and
               100 in both selection modes, and a SuCo index (linear
               activation, fixed selection) built at full width; each run is
               held against the plain path, the query-aware runs also against
               masked-full; heap and linear activation against sort on the
               first 100 queries;
  7. persist — AnnIndex.save of the TaCo and the SuCo index to a temporary
               directory, AnnIndex.load on the card: every array bitwise equal,
               and masked-full and gather ids and dists of one batch bitwise
               equal to the in-memory index's; a repeated batch hits the
               searcher's cache;
  8. summary — the card's nvidia-smi line, one JSON line with every kernel's
               numbers, and the final {"ok": true, ...} line.

Each path's kernels must be launched in its own run: the launch counts are
set to 0 just before the path is driven and read just after (build:
kmeans_assign; flash: flash_attention; masked: l2dist, schist,
masked_rerank; gather: l2dist, scscore; persist: l2dist, schist,
masked_rerank, scscore), l2dist exactly once a query batch and
kmeans_assign exactly kmeans_iters + 1 times a build. The full result is
also written to chiprun_out/chip_smoke.json.

It imports nothing of the JAX package; the corpus comes from the port's own
seeded gmm_dataset.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

#: H100 SXM published peaks (NVIDIA data sheet): HBM bytes/s and float32
#: non-tensor FLOP/s. Integer collision tests are counted at the same
#: 32-bit non-tensor rate.
HBM_BPS = 3.35e12
F32_OPS = 67e12
#: dense bf16 tensor-core FLOP/s (same data sheet)
BF16_TENSOR_OPS = 989e12
QUERIES = 1000
SOURCES = {
    "l2dist": ("src/repro_torch/csrc/l2dist.cu", "src/repro/kernels/l2dist.py:61"),
    "kmeans_assign": ("src/repro_torch/csrc/kmeans_assign.cu",
                      "src/repro/kernels/kmeans_assign.py:44"),
    "schist": ("src/repro_torch/csrc/schist.cu", "src/repro/kernels/schist.py:125"),
    "masked_rerank": ("src/repro_torch/csrc/masked_rerank.cu",
                      "src/repro/kernels/masked_rerank.py:234"),
    "scscore": ("src/repro_torch/csrc/scscore.cu", "src/repro/kernels/scscore.py:63"),
    "flash_attention": ("src/repro_torch/csrc/flash_attention.cu",
                        "src/repro/kernels/flash_attention.py:99"),
}
#: the kernels each path must launch in its own run
PATHS = {
    "build": ("kmeans_assign",),
    "masked": ("l2dist", "schist", "masked_rerank"),
    "gather": ("l2dist", "scscore"),
    "flash": ("flash_attention",),
    "persist": ("l2dist", "schist", "masked_rerank", "scscore"),
}


class SmokeFailure(Exception):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def bound_ms(nbytes: float, ops: float, rate: float = F32_OPS) -> tuple[float, str]:
    tb, to = nbytes / HBM_BPS * 1e3, ops / rate * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def timed(torch, fn, reps: int, warmup: int = 1) -> float:
    """Mean device ms per call, CUDA events around ``reps`` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


#: schist against its plain version, as in the card tests: (N_s, Q, K, n,
#: table fill). n below one 2048-point chunk, not a multiple of it, 10^6.
SCHIST_CASES = (
    (1, 1, 1024, 1000, "random"), (3, 33, 25, 5003, "random"),
    (6, 37, 1024, 20017, "random"), (6, 1000, 1024, 10 ** 6, "random"),
    (3, 1, 64, 10 ** 6, "random"), (8, 1000, 512, 20017, "random"),
    (16, 33, 256, 4099, "random"), (16, 1025, 2048, 20017, "random"),
    (16, 37, 2048, 1000, "random"), (6, 1025, 1024, 10 ** 6, "ones"),
    (6, 1000, 1024, 2100, "zeros"), (16, 1025, 2048, 5003, "ones"),
)


def kmeans_pairs_case(torch, label: str, n: int, k: int, dims, ints, floats,
                      scale_atol) -> dict:
    """The batched kmeans_assign at P = len(dims) pairs of n points and k
    centroids, pair p of width dims[p], zero-padded to a multiple of 4:
    integer inputs bit for bit against the plain version; float inputs bit
    for bit against one single-pair launch per pair at its own width, and
    against the plain version (argmin where the two nearest are clearly
    apart, the min within the l2dist tolerance). Timed beside the 12 single
    launches, the plain version, ``torch.cdist(xs, cs).min(-1)`` on the
    stack and the bound."""
    from repro_torch.kernels.kmeans_assign import (
        kmeans_assign_cuda,
        kmeans_assign_pairs_cuda,
        kmeans_assign_pairs_plain,
    )
    from repro_torch.kernels.l2dist import l2dist_plain

    n_pairs, w = len(dims), -(-max(dims) // 4) * 4

    def stack(draw):
        xs = torch.zeros((n_pairs, n, w), device="cuda")
        cs = torch.zeros((n_pairs, k, w), device="cuda")
        for p, d in enumerate(dims):
            xs[p, :, :d], cs[p, :, :d] = draw((n, d)), draw((k, d))
        return xs, cs

    xs, cs = stack(ints)
    ga, gd = kmeans_assign_pairs_cuda(xs, cs, dims)
    wa, wd = kmeans_assign_pairs_plain(xs, cs, dims)
    check(torch.equal(ga, wa) and torch.equal(gd, wd), f"kmeans_assign pairs int {label}")
    xs, cs = stack(floats)
    ga, gd = kmeans_assign_pairs_cuda(xs, cs, dims)
    halves = [(xs[p, :, :d].contiguous(), cs[p, :, :d].contiguous()) for p, d in enumerate(dims)]
    for p, (x, c) in enumerate(halves):
        sa, sdm = kmeans_assign_cuda(x, c)
        check(torch.equal(ga[p], sa) and torch.equal(gd[p].view(torch.int32),
                                                     sdm.view(torch.int32)),
              f"kmeans_assign pairs vs single launch {label} pair {p}")
    wa, wd = kmeans_assign_pairs_plain(xs, cs, dims)
    agree = 0.0
    for p, (x, c) in enumerate(halves):
        two = torch.topk(l2dist_plain(x, c), 2, dim=1, largest=False).values
        clear = (two[:, 1] - two[:, 0]) > 1e-5 * two[:, 0].clamp_min(1e-30)
        check(bool(torch.equal(ga[p][clear], wa[p][clear])),
              f"kmeans_assign pairs float argmin {label} pair {p}")
        check(torch.allclose(gd[p], wd[p], rtol=1e-5, atol=scale_atol(x, c)),
              f"kmeans_assign pairs float min {label} pair {p}")
        agree += float((ga[p] == wa[p]).float().mean()) / n_pairs
        del two, clear
    b, by = bound_ms(4 * (n_pairs * n * w + n_pairs * k * w + 2 * n_pairs * n),
                     sum(n * k * (2 * d + 3) + 2 * d * (n + k) for d in dims))
    row = dict(
        max_abs_err=float((gd - wd).abs().max()),
        ms=timed(torch, lambda: kmeans_assign_pairs_cuda(xs, cs, dims), 50),
        single_launches_ms=timed(torch, lambda: [kmeans_assign_cuda(x, c) for x, c in halves], 50),
        plain_ms=timed(torch, lambda: kmeans_assign_pairs_plain(xs, cs, dims), 3),
        bound_ms=b, bound_by=by,
        library_ms=timed(torch, lambda: torch.cdist(xs, cs).min(dim=-1), 3),
        argmin_agree=agree,
        shape=f"{n_pairs} pairs, x ({n}, {w}) (widths {dims}), c ({k}, {w})")
    print(f"kernel kmeans_assign {label}: {json.dumps(row)}", flush=True)
    return row


def phase_kernels(torch, corpus, queries, rng) -> dict:
    """Phase 3: every ANN kernel against its plain version on the card."""
    import numpy as np

    from repro_torch.core.activation import activation_taus
    from repro_torch.core.selection import query_aware_threshold
    from repro_torch.kernels.kmeans_assign import kmeans_assign_cuda, kmeans_assign_plain
    from repro_torch.core.taco import _half_slices
    from repro_torch.kernels.l2dist import (
        l2dist_cuda,
        l2dist_pairs_cuda,
        l2dist_pairs_plain,
        l2dist_plain,
    )
    from repro_torch.kernels.masked_rerank import (
        masked_rerank_cuda,
        masked_rerank_plain,
        rerank_geometry,
        rerank_resident_warps,
    )
    from repro_torch.kernels.schist import (
        collision_bits,
        collision_table,
        schist_cuda,
        schist_geometry,
        schist_plain,
        unpack_collision_bits,
    )
    from repro_torch.kernels.scscore import scscore_cuda, scscore_plain

    dev = torch.device("cuda")
    res = {}

    def T(a, dtype=None):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype).to(dev)

    def ints(shape, lo=-8, hi=9):
        return T(rng.integers(lo, hi, shape).astype(np.float32))

    def floats(shape):
        return T(rng.standard_normal(shape).astype(np.float32))

    def scale_atol(x, y):  # cancellation floor of the |x|^2+|y|^2-2x.y form
        return 1e-5 * float((x * x).sum(1).max() + (y * y).sum(1).max())

    # ---------------------------------------------------------- l2dist --
    q, n_sub, sqrt_k, sd = QUERIES, 6, 32, 4
    for shape in ((q, sqrt_k, sd), (37, 29, 5)):
        x, y = ints(shape[::2]), ints(shape[1:])
        check(torch.equal(l2dist_cuda(x, y), l2dist_plain(x, y)), f"l2dist int {shape}")
        x, y = floats(shape[::2]), floats(shape[1:])
        got, want = l2dist_cuda(x, y), l2dist_plain(x, y)
        check(torch.allclose(got, want, rtol=1e-5, atol=scale_atol(x, y)),
              f"l2dist float {shape}")
    # the main path's batch: 2 N_s = 12 (subspace, half) pairs of half-dim 4
    # in one launch, bitwise equal to one single-pair launch per pair
    slices = _half_slices((2 * sd,) * n_sub)
    for x_sh, y_sh, sl in (((q, 2 * sd * n_sub), (2 * n_sub, sqrt_k, sd), slices),
                           ((37, 65), (6, 29, 12), _half_slices((21, 21, 23)))):
        x, y = floats(x_sh), floats(y_sh)
        for p, (_c, w) in enumerate(sl):
            y[p, :, w:] = 0
        got = l2dist_pairs_cuda(x, sl, y)
        singles = torch.stack([l2dist_cuda(x[:, c:c + w].contiguous(), y[p, :, :w].contiguous())
                               for p, (c, w) in enumerate(sl)])
        check(torch.equal(got, singles), f"l2dist pairs vs single launches {x_sh} {y_sh}")
        want = l2dist_pairs_plain(x, sl, y)
        check(torch.allclose(got, want, rtol=1e-5, atol=scale_atol(x, y.flatten(0, 1))),
              f"l2dist pairs float {x_sh} {y_sh}")
    x, y = floats((q, 2 * sd * n_sub)), floats((2 * n_sub, sqrt_k, sd))
    xb = torch.stack([x[:, c:c + w] for c, w in slices])
    got, want = l2dist_pairs_cuda(x, slices, y), l2dist_pairs_plain(x, slices, y)
    pairs = len(slices)
    b, by = bound_ms(4 * (q * 2 * sd * n_sub + pairs * sqrt_k * sd + pairs * q * sqrt_k),
                     pairs * (q * sqrt_k * (2 * sd + 3) + 2 * sd * (q + sqrt_k)))
    res["l2dist"] = dict(
        max_abs_err=float((got - want).abs().max()),
        ms=timed(torch, lambda: l2dist_pairs_cuda(x, slices, y), 200),
        # the parent's path: a contiguous copy of each slice, one launch a pair
        single_launches_ms=timed(torch, lambda: [l2dist_cuda(x[:, c:c + w].contiguous(), y[p])
                                                 for p, (c, w) in enumerate(slices)], 200),
        plain_ms=timed(torch, lambda: l2dist_pairs_plain(x, slices, y), 200),
        bound_ms=b, bound_by=by,
        library_ms=timed(torch, lambda: torch.cdist(xb, y) ** 2, 200),
        shape=f"{pairs} pairs, x ({q}, {2 * sd * n_sub}), half-dim {sd}, sqrt_k {sqrt_k}")

    # --------------------------------------------------- kmeans_assign --
    # the single-pair entry: the main path's half and a ragged shape
    n = corpus.shape[0]
    for shape in ((n, sqrt_k, sd), (1003, 13, 3)):
        x, c = ints(shape[::2]), ints(shape[1:])
        ga, gd = kmeans_assign_cuda(x, c)
        wa, wd = kmeans_assign_plain(x, c)
        check(torch.equal(ga, wa) and torch.equal(gd, wd), f"kmeans_assign int {shape}")
        x, c = floats(shape[::2]), floats(shape[1:])
        ga, gd = kmeans_assign_cuda(x, c)
        wa, wd = kmeans_assign_plain(x, c)
        two = torch.topk(l2dist_plain(x, c), 2, dim=1, largest=False).values
        clear = (two[:, 1] - two[:, 0]) > 1e-5 * two[:, 0].clamp_min(1e-30)
        check(bool(torch.equal(ga[clear], wa[clear])), f"kmeans_assign float argmin {shape}")
        check(torch.allclose(gd, wd, rtol=1e-5, atol=scale_atol(x, c)),
              f"kmeans_assign float min {shape}")
    x, c = floats((n, sd)), floats((sqrt_k, sd))
    one_pair_ms = timed(torch, lambda: kmeans_assign_cuda(x, c), 50)
    # the build's launch: its 2 N_s = 12 (subspace, half) pairs, TaCo's
    # halves of 4 and SuCo's (128 dims over 6 subspaces) of 10/11 and 11/12
    # zero-padded to 12, and a ragged case
    rows = {label: kmeans_pairs_case(torch, label, n_, k_, dims, ints, floats, scale_atol)
            for label, n_, k_, dims in (("taco", n, sqrt_k, [sd] * 2 * n_sub),
                                        ("suco", n, sqrt_k, [10, 11] * 5 + [11, 12]),
                                        ("ragged", 1003, 13, [3, 5, 7]))}
    res["kmeans_assign"] = dict(rows["taco"], one_pair_ms=one_pair_ms,
                                one_pair_shape=f"x ({n}, {sd}), c ({sqrt_k}, {sd})",
                                suco=rows["suco"], ragged=rows["ragged"])
    del x, c
    torch.cuda.empty_cache()

    # ------------------------------------------- schist + masked_rerank --
    def collision_case(n_sub, q, sqrt_k, n, alpha=0.05):
        cells = T(rng.integers(0, sqrt_k * sqrt_k, (n_sub, n)), torch.int32)
        sizes = torch.stack([torch.bincount(cells[s].long(), minlength=sqrt_k ** 2)
                             for s in range(n_sub)]).to(torch.int32).reshape(n_sub, sqrt_k, sqrt_k)
        d1s = T(rng.uniform(0, 4, (n_sub, q, sqrt_k)).astype(np.float32))
        d2s = T(rng.uniform(0, 4, (n_sub, q, sqrt_k)).astype(np.float32))
        taus, _ = activation_taus(d1s, d2s, sizes, alpha * n)
        return collision_bits(collision_table(d1s, d2s, taus)), cells

    big = (n_sub, q, sqrt_k, n)
    for shape in (big, (3, 37, 5, 1003)):
        bits, cells = collision_case(*shape)
        got = schist_cuda(bits, cells, shape[0] + 1, q=shape[1])
        want = schist_plain(bits, cells, shape[0] + 1, q=shape[1])
        check(torch.equal(got, want), f"schist {shape}")
        check(bool((got.sum(1) == shape[3]).all()), f"schist counts {shape}")
    # the card tests' shapes: packed words drawn at random (padding bits
    # set too), all ones and all zeros; N_s 16 at K 2048 holds one tile
    for n_s, q_, k2, n_, fill in SCHIST_CASES:
        qt = (q_ + 31) // 32
        if fill == "random":
            words = T(rng.integers(-2 ** 31, 2 ** 31, (qt, n_s, k2)), torch.int32)
        else:
            words = torch.full((qt, n_s, k2), -1 if fill == "ones" else 0, dtype=torch.int32,
                               device=dev)
        cells = T(rng.integers(0, k2, (n_s, n_)), torch.int32)
        got = schist_cuda(words, cells, n_s + 1, q=q_)
        check(torch.equal(got, schist_plain(words, cells, n_s + 1, q=q_)),
              f"schist {(n_s, q_, k2, n_, fill)}")
        check(bool((got.sum(1) == n_).all()), f"schist counts {(n_s, q_, k2, n_, fill)}")
    bits, cells = collision_case(*big)
    hist = schist_cuda(bits, cells, n_sub + 1, q=q)
    nbits = bits.numel() * 4
    b, by = bound_ms(4 * n_sub * n + nbits + 4 * q * (n_sub + 1), q * n * n_sub)
    res["schist"] = dict(
        max_abs_err=float((hist - schist_plain(bits, cells, n_sub + 1, q=q)).abs().max()),
        ms=timed(torch, lambda: schist_cuda(bits, cells, n_sub + 1, q=q), 10),
        plain_ms=timed(torch, lambda: schist_plain(bits, cells, n_sub + 1, q=q), 2),
        bound_ms=b, bound_by=by, library_ms=None,
        shape=f"Q {q}, N_s {n_sub}, K {sqrt_k ** 2}, n {n}",
        geometry=dict(zip(("tiles", "warps", "smem_bytes", "tile_groups"),
                          schist_geometry(q, n_sub, sqrt_k ** 2))))

    # --------------------------------------------------------- scscore --
    # the ragged shapes: Q not a multiple of 32, n not a multiple of the chunk
    for shape in (big, (n_sub, 100, sqrt_k, 20000), (3, 37, 5, 1003)):
        bits, cells = collision_case(*shape)
        got = scscore_cuda(bits, cells, q=shape[1])
        check(torch.equal(got, scscore_plain(bits, cells, q=shape[1])), f"scscore {shape}")
        del got
    bits, cells = collision_case(*big)
    sc = scscore_cuda(bits, cells, q=q)
    b, by = bound_ms(4 * q * n + 4 * n_sub * n + nbits, q * n * n_sub)
    res["scscore"] = dict(
        max_abs_err=float((sc - scscore_plain(bits, cells, q=q)).abs().max()),
        ms=timed(torch, lambda: scscore_cuda(bits, cells, q=q), 10),
        plain_ms=timed(torch, lambda: scscore_plain(bits, cells, q=q), 2),
        bound_ms=b, bound_by=by, library_ms=None,
        shape=f"Q {q}, N_s {n_sub}, K {sqrt_k ** 2}, n {n}")
    del sc
    torch.cuda.empty_cache()

    def rerank_case(shape, data, qs, k):
        n_sub_, q_, sqrt_k_, n_ = shape
        bits, cells = collision_case(*shape)
        hist = schist_plain(bits, cells, n_sub_ + 1, q=q_)
        thresh, demand = query_aware_threshold(hist, 0.005 * n_, n_sub_)
        norms = (data * data).sum(1)
        return (bits, cells, thresh, qs, data, norms), demand

    def compare_rerank(args_, k, exact: bool, what: str):
        gd, gi = masked_rerank_cuda(*args_, k)
        wd, wi = masked_rerank_plain(*args_, k)
        if exact:
            check(torch.equal(gi, wi) and torch.equal(gd, wd), f"masked_rerank int {what}")
            return gd, gi, wd, wi
        agree = float((gi == wi).float().mean())
        fin = torch.isfinite(wd)
        check(torch.equal(fin, torch.isfinite(gd)), f"masked_rerank filled slots {what}")
        atol = scale_atol(args_[3], args_[4])
        check(torch.allclose(gd[fin], wd[fin], rtol=1e-5, atol=atol), f"masked_rerank dists {what}")
        check(agree >= 0.999, f"masked_rerank ids agree {agree:.5f} < 0.999 {what}")
        return gd, gi, wd, wi

    for shape, d, k in (((n_sub, q, sqrt_k, 65536), 128, 10),
                        ((n_sub, q, sqrt_k, 65536), 128, 100),
                        ((3, 37, 5, 1003), 20, 17)):
        args_, _ = rerank_case(shape, ints((shape[3], d)), ints((shape[1], d)), k)
        compare_rerank(args_, k, True, f"{shape} k={k}")
    timings = {}
    for k in (10, 100):
        args_, demand = rerank_case(big, corpus, queries, k)
        gd, gi, wd, wi = compare_rerank(args_, k, False, f"{big} k={k}")
        fin = torch.isfinite(wd)
        total = float(demand.sum())
        d = corpus.shape[1]
        b, by = bound_ms(
            4 * n_sub * n + nbits + 4 * q + 4 * q * d + 4 * d * min(n, total) + 4 * n + 8 * q * k,
            q * n * n_sub + total * (2 * d + 3))
        mask_sc = None

        def library():
            nonlocal mask_sc
            if mask_sc is None:
                table = unpack_collision_bits(args_[0], q)
                sc = torch.zeros((q, n), dtype=torch.uint8, device=dev)
                for s in range(n_sub):
                    sc += table[s][:, args_[1][s].long()]
                mask_sc = sc >= args_[2][:, None].to(torch.uint8)
            qn = (args_[3] * args_[3]).sum(1, keepdim=True)
            dist = torch.addmm(args_[5][None, :], args_[3], args_[4].T, alpha=-2.0) + qn
            return torch.topk(torch.where(mask_sc, dist, torch.inf), k, dim=1, largest=False)

        library()
        timings[k] = dict(
            max_abs_err=float((gd[fin] - wd[fin]).abs().max()) if fin.any() else 0.0,
            ms=timed(torch, lambda: masked_rerank_cuda(*args_, k), 5),
            plain_ms=timed(torch, lambda: masked_rerank_plain(*args_, k), 1),
            bound_ms=b, bound_by=by,
            library_ms=timed(torch, library, 3),
            ids_agree=float((gi == wi).float().mean()),
            mean_candidates=total / q,
            shape=f"Q {q}, n {n}, d {d}, k {k}",
            geometry=dict(zip(("lanes", "warps", "chunk", "n_chunks", "smem_bytes"),
                              rerank_geometry(n, k, n_sub, sqrt_k ** 2, d))),
            resident_warps_per_sm=rerank_resident_warps(n, k, n_sub, sqrt_k ** 2, d))
        del mask_sc
        print(f"kernel masked_rerank k={k}: {json.dumps(timings[k])}", flush=True)
    res["masked_rerank"] = timings[10]
    for name in ("l2dist", "kmeans_assign", "schist", "scscore"):
        print(f"kernel {name}: {json.dumps(res[name])}", flush=True)
    torch.cuda.empty_cache()
    return res


#: (label, BH, KV heads, S, T, hd, causal, dtype): granite-3-2b (32 query
#: heads of 2048/32 = 64; its 8 KV heads repeated to 32 by the caller, as
#: the op takes equal BH) and qwen1.5-4b (MHA, 20 heads of 128) at
#: S = T = 4096, and a ragged non-causal case. Both head dims run in f32 and
#: bf16. The first row is the one in the kernels line.
FLASH_CASES = (
    ("granite-3-2b bf16", 32, 8, 4096, 4096, 64, True, "bfloat16"),
    ("granite-3-2b f32", 32, 8, 4096, 4096, 64, True, "float32"),
    ("qwen1.5-4b bf16", 20, 20, 4096, 4096, 128, True, "bfloat16"),
    ("qwen1.5-4b f32", 20, 20, 4096, 4096, 128, True, "float32"),
    ("ragged non-causal bf16", 32, 32, 4000, 4097, 64, False, "bfloat16"),
)
#: rtol = atol against the plain version in the same dtype. f32 keeps the
#: reference tests' 2e-5 (tests/test_kernels.py:136). bf16 is tighter than
#: their 5e-2, which was set at 32 keys: at 4096 keys a late row's output is
#: about 0.03, so 1e-2 sits above one bf16 rounding flip of an output below
#: 1 (<= 0.0039) and below a typical late value.
FLASH_TOL = {"float32": 2e-5, "bfloat16": 1e-2}
#: bf16 is also held against the plain version run in f32 on the same
#: (upcast) inputs: the kernel accumulates in f32 and rounds once, so it may
#: differ by one bf16 rounding (half an ulp, at most 2^-8 relative; 2^-7 is
#: allowed) plus the f32 tolerance twice over. This holds every row, late
#: ones too, to about one percent of its value.
FLASH_BF16_VS_F32 = (2.0 ** -7, 4e-5)


def phase_flash(torch) -> dict:
    """Phase 4: ops.flash_attention on every case (the path run), then each
    case against the plain version, timed beside its bound and SDPA."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops
    from repro_torch.kernels.flash_attention import flash_attention_cuda, flash_attention_plain

    gen = torch.Generator(device="cuda").manual_seed(0)
    inputs = []
    for label, bh, kv_heads, s, t, hd, causal, dtype in FLASH_CASES:
        dt = getattr(torch, dtype)
        q = torch.randn((bh, s, hd), generator=gen, device="cuda").to(dt)
        k, v = (torch.randn((kv_heads, t, hd), generator=gen, device="cuda").to(dt)
                .repeat_interleave(bh // kv_heads, dim=0) for _ in range(2))
        inputs.append((q, k, v, causal))
    copies = fa.aligned_copies
    outs, launches = run_path(torch, "flash",
                              lambda: [ops.flash_attention(*a) for a in inputs])
    copies = fa.aligned_copies - copies
    check(copies == 0, f"flash: {copies} aligned copies on the path's shapes")
    rows = []
    for (label, bh, _kv, s, t, hd, causal, dtype), (q, k, v, _c), got in zip(
            FLASH_CASES, inputs, outs):
        want = flash_attention_plain(q, k, v, causal)
        err = float((got.float() - want.float()).abs().max())
        tol = FLASH_TOL[dtype]
        check(tuple(got.shape) == (bh, s, hd) and got.dtype == q.dtype, f"flash {label} shape")
        check(torch.allclose(got.float(), want.float(), rtol=tol, atol=tol),
              f"flash {label}: max abs err {err} above {tol}")
        err_f32 = used = None
        if dtype == "bfloat16":
            want = flash_attention_plain(q.float(), k.float(), v.float(), causal)
            diff = (got.float() - want).abs()
            rtol, atol = FLASH_BF16_VS_F32
            err_f32 = float(diff.max())
            # worst share of the allowed error any element uses (<= 1 passes)
            used = float((diff / (atol + rtol * want.abs())).max())
            check(used <= 1.0, f"flash {label}: {used} of the allowed error against "
                               f"the f32 plain version (max abs err {err_f32})")
            del diff
        del want
        torch.cuda.empty_cache()
        # unmasked (query, key) pairs: top-left causal keeps min(q + 1, T) keys
        pairs = bh * (sum(min(i + 1, t) for i in range(s)) if causal else s * t)
        flops = 4 * hd * pairs
        nbytes = q.element_size() * bh * hd * (2 * s + 2 * t)
        b32, by32 = bound_ms(nbytes, flops, F32_OPS)
        b16, by16 = bound_ms(nbytes, flops, BF16_TENSOR_OPS)
        sdpa = torch.nn.functional.scaled_dot_product_attention
        row = dict(case=label, shape=f"BH {bh}, S {s}, T {t}, hd {hd}, causal {causal}, {dtype}",
                   max_abs_err=err, tolerance=tol, max_abs_err_vs_f32=err_f32,
                   share_of_allowed_vs_f32=used,
                   ms=timed(torch, lambda: flash_attention_cuda(q, k, v, causal), 5),
                   plain_ms=timed(torch, lambda: flash_attention_plain(q, k, v, causal), 2),
                   library_ms=timed(torch, lambda: sdpa(q[None], k[None], v[None],
                                                        is_causal=causal), 10),
                   gflop=flops / 1e9, bound_f32_ms=b32, bound_f32_by=by32,
                   bound_bf16_tensor_ms=b16, bound_bf16_tensor_by=by16)
        # the least time for the work at its input type's peak rate: f32 on
        # the CUDA cores, bf16 on the tensor cores
        row["bound_ms"], row["bound_by"] = (b32, by32) if dtype == "float32" else (b16, by16)
        if dtype == "bfloat16":
            # the kernel's own work: P.V twice (P as bf16 hi + lo), 6 hd a pair
            row["bound_split_ms"] = bound_ms(nbytes, 6 * hd * pairs, BF16_TENSOR_OPS)[0]
        row["tflops"] = flops / row["ms"] / 1e9
        row["vs_library"] = row["ms"] / row["library_ms"]
        print(f"flash: {json.dumps(row)}", flush=True)
        rows.append(row)
        torch.cuda.empty_cache()
    return {"cases": rows, "launches": launches, "aligned_copies": copies}


def profile_search(torch, view, queries, label: str) -> None:
    """Device time by kernel over one k=10 search of ``view`` (an index
    with the pipeline to profile), from torch.profiler, and the device's
    busy share of the window. Only device-side events count: a host-side
    op (``aten::...``) also reports the device time of the kernels it
    launched, and summing both would count that time twice."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        view.search_with_stats(queries, k=10)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    rows = []
    for evt in prof.key_averages():
        if evt.device_type != DeviceType.CUDA:
            continue
        dev_us = getattr(evt, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(evt, "self_cuda_time_total", 0)
        if dev_us > 0:
            rows.append((dev_us, evt.count, evt.key))
    rows.sort(reverse=True)
    total = sum(r[0] for r in rows)
    if total == 0:
        print(f"profile {label}: no device time in the trace (not measured)", flush=True)
        return
    print(f"profile {label}: window {wall_us:.0f} us (profiled), device busy {total:.0f} us "
          f"({100 * total / wall_us:.1f}%)", flush=True)
    for dev_us, count, key in rows[:12]:
        print(f"profile {label}: {dev_us:10.0f} us {100 * dev_us / total:5.1f}% x{count:<5d} "
              f"{key[:90]}", flush=True)


def profile_build(torch, corpus_np, cfg, label: str):
    """(index, build seconds, profile): AnnIndex.build from host memory under
    torch.profiler. The profile holds the host clock of the window, the
    device's busy time (device-side events only, as in
    :func:`profile_search`), the top device operations, and the top host
    operations by their own (self) CPU time, which shows the host-side work
    outside the device's: the CPU generator's ``randperm``s, the pageable
    host-to-device copy of the corpus, ``eigh``'s solver, one-time set-up
    in the process's first build, and the waits on the device."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.ann import AnnIndex

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        index = AnnIndex.build(corpus_np, cfg)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
    wall_us = build_s * 1e6
    print(f"{label}: build {build_s:.3f} s (profiled), index_bytes {index.index_bytes}",
          flush=True)
    device, host = [], []
    for evt in prof.key_averages():
        if evt.device_type == DeviceType.CUDA:
            us = getattr(evt, "self_device_time_total", None)
            if us is None:
                us = getattr(evt, "self_cuda_time_total", 0)
            rows = device
        else:
            us, rows = evt.self_cpu_time_total, host
        if us > 0:
            rows.append((us, evt.count, evt.key))
    device.sort(reverse=True)
    host.sort(reverse=True)
    busy = sum(r[0] for r in device)
    out = dict(wall_us=wall_us, device_busy_us=busy, host_self_us=sum(r[0] for r in host),
               top_device=[dict(us=us, count=c, op=key) for us, c, key in device[:12]],
               top_host=[dict(us=us, count=c, op=key) for us, c, key in host[:15]])
    if busy == 0:
        print("profile build: no device time in the trace (not measured)", flush=True)
    print(f"profile build: window {wall_us:.0f} us (profiled), device busy {busy:.0f} us "
          f"({100 * busy / wall_us:.1f}%), host ops' self time {out['host_self_us']:.0f} us",
          flush=True)
    for us, count, key in device[:12]:
        print(f"profile build: device {us:10.0f} us {100 * us / wall_us:5.1f}% x{count:<5d} "
              f"{key[:90]}", flush=True)
    for us, count, key in host[:15]:
        print(f"profile build: host   {us:10.0f} us {100 * us / wall_us:5.1f}% x{count:<5d} "
              f"{key[:90]}", flush=True)
    return index, build_s, out


def integer_build_check(torch) -> dict:
    """A SuCo index over an integer-valued 10^5 x 128 corpus (values in
    [-20, 20]) built on the card, the halves of 10/11 and 11/12 dims in one
    lockstep k-means padded to 12, against one k-means per (subspace, half)
    run on the card in this call: every array bit for bit. Float32 sums of
    integers below 2^24 are exact in any order, so the card's atomics in
    ``index_add_`` cannot tell the two apart; the distances to the
    non-integer means then agree only if the batched kernel's arithmetic is
    the single-pair one."""
    import numpy as np

    from repro_torch.clustering import kmeans
    from repro_torch.core import imi, taco
    from repro_torch.core.config import suco_config

    data = np.random.default_rng(7).integers(-20, 21, (100_000, 128)).astype(np.float32)
    cfg = suco_config(n_subspaces=6, n_clusters=1024, alpha=0.05, beta=0.005, k=10,
                      use_kernels=True)
    index = taco.build(data, cfg)
    projected = taco._project(index, torch.as_tensor(data, device="cuda"))
    gen = torch.Generator().manual_seed(cfg.seed)
    for s, ((lo, hi), sub) in enumerate(zip(taco._sub_slices(index.sub_dims), index.subspaces)):
        s1, _s2 = imi.split_halves(hi - lo)
        c1, a1 = kmeans(projected[:, lo:lo + s1], cfg.sqrt_k, cfg.kmeans_iters, cfg.kmeans_init,
                        generator=gen)
        c2, a2 = kmeans(projected[:, lo + s1:hi], cfg.sqrt_k, cfg.kmeans_iters, cfg.kmeans_init,
                        generator=gen)
        same = (torch.equal(sub.centroids1, c1) and torch.equal(sub.centroids2, c2)
                and torch.equal(sub.assign1, a1) and torch.equal(sub.assign2, a2)
                and torch.equal(sub.cell_sizes, imi.cell_sizes(a1, a2, cfg.sqrt_k)))
        check(same, f"integer SuCo build: subspace {s} differs from the per-pair k-means")
    row = dict(n=data.shape[0], sub_dims=list(index.sub_dims), subspaces=len(index.subspaces),
               bitwise=True)
    print(f"build: integer SuCo index equals the per-pair k-means: {json.dumps(row)}", flush=True)
    return row


def run_path(torch, name: str, fn, expect: dict | None = None):
    """Run ``fn`` with every launch count set to 0 just before it; return
    its result and the counts read just after. Fails if a kernel of the
    path was launched no time, or if a kernel named in ``expect`` was not
    launched exactly that many times (``l2dist`` once a query batch,
    ``kmeans_assign`` once a Lloyd iteration and once more a build)."""
    from repro_torch.kernels import cuda

    cuda.reset_launch_counts()
    out = fn()
    torch.cuda.synchronize()
    launches = dict(cuda.launch_counts)
    print(f"{name}: launches {json.dumps(launches)}", flush=True)
    for kernel in PATHS[name]:
        check(launches[kernel] > 0, f"kernel {kernel} was not launched on the {name} path")
    for kernel, count in (expect or {}).items():
        check(launches[kernel] == count,
              f"{name}: {kernel} launched {launches[kernel]} times, expected {count}")
    return out, launches


def build_index(torch, corpus_np, cfg, label: str):
    """(index, build seconds): AnnIndex.build on the card, synchronized."""
    from repro_torch.ann import AnnIndex

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    index = AnnIndex.build(corpus_np, cfg)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    print(f"{label}: build {build_s:.3f} s, index_bytes {index.index_bytes}", flush=True)
    return index, build_s


def search_runs(torch, index, queries, settings) -> dict:
    """For each (k, selection): seconds (median of 3 synchronized host-clock
    runs of the whole batch through the facade, which pads it to its
    bucket and returns numpy), ids, dists, stats and the peak bytes
    allocated."""
    runs = {}
    for k, sel in settings:
        view = index.replace_cfg(selection=sel)
        torch.cuda.reset_peak_memory_stats()
        times = []
        for _rep in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            ids, dists, stats = view.search_with_stats(queries, k=k)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        runs[(k, sel)] = dict(seconds=sorted(times)[1], ids=ids, dists=dists, stats=stats,
                              peak_bytes=torch.cuda.max_memory_allocated())
    return runs


def against_plain(torch, index, queries, gt, run, k: int, sel: str, label: str) -> dict:
    """The run's row: QPS, recall@10, and the plain path (use_kernels=False)
    on the same index, held to the stated limits."""
    import numpy as np

    from repro_torch.utils import recall_at_k

    ids, dists, stats = run["ids"], run["dists"], run["stats"]
    check(tuple(ids.shape) == (queries.shape[0], k), f"{label} ids shape k={k}")
    check(bool(np.isfinite(dists[:, :10]).all()), f"{label} finite top-10 dists k={k} {sel}")
    rec = recall_at_k(ids, gt, 10)
    plain = index.replace_cfg(selection=sel, use_kernels=False)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pids, _pd, _ps = plain.search_with_stats(queries, k=k)
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t0
    del _ps
    prec = recall_at_k(pids, gt, 10)
    same = float(np.mean(pids == ids))
    secs = run["seconds"]
    row = dict(k=k, selection=sel, seconds=secs, qps=queries.shape[0] / secs,
               recall_at_10=rec, plain_recall_at_10=prec, plain_seconds=plain_s,
               ids_same_as_plain=same,
               mean_candidate_count=float(stats["candidate_count"].mean()),
               truncated_share=float(stats["truncated"].mean()),
               peak_gib=run["peak_bytes"] / 2**30)
    check(abs(rec - prec) <= 0.005, f"{label} recall kernel {rec} vs plain {prec} k={k} {sel}")
    check(same >= 0.999, f"{label} ids same as plain {same} < 0.999 k={k} {sel}")
    return row


SETTINGS = [(k, sel) for k in (10, 100) for sel in ("query_aware", "fixed")]


def phase_masked(torch, corpus_np, queries, gt) -> tuple:
    """Phase 5: build the TaCo index and answer the batch with the
    masked-full pipeline through AnnIndex. Returns (index, summary, runs)."""
    from repro_torch.core.config import taco_config

    cfg = taco_config(n_subspaces=6, subspace_dim=8, n_clusters=1024, alpha=0.05,
                      beta=0.005, k=10, rerank="masked_full", use_kernels=True)
    # the process's first build, profiled; then one more, unprofiled
    (index, build_s, build_profile), build_launches = run_path(
        torch, "build", lambda: profile_build(torch, corpus_np, cfg, "masked"),
        expect={"kmeans_assign": cfg.kmeans_iters + 1})
    warm_build_s = build_index(torch, corpus_np, cfg, "masked again")[1]
    integer_build = integer_build_check(torch)
    index.search(queries[:8])  # warm-up: caches the per-index cell ids
    runs, launches = run_path(torch, "masked", lambda: search_runs(torch, index, queries, SETTINGS),
                              expect={"l2dist": 3 * len(SETTINGS)})
    profile_search(torch, index, queries, "masked")
    summary = {"build_s": build_s, "warm_build_s": warm_build_s,
               "index_bytes": index.index_bytes, "searches": [],
               "build_launches": build_launches, "build_profile": build_profile,
               "integer_build": integer_build, "launches": launches}
    for (k, sel), run in runs.items():
        row = against_plain(torch, index, queries, gt, run, k, sel, "masked")
        print(f"masked: search {json.dumps(row)}", flush=True)
        summary["searches"].append(row)
    return index, summary, runs


def phase_gather(torch, taco_index, corpus_np, queries, gt, masked_runs) -> tuple:
    """Phase 6: the default gather pipeline on the TaCo index, then on a
    SuCo index built at full width, each run held against the plain path
    (and the query-aware runs against masked-full); the heap and linear
    activations against sort on the first 100 queries. Returns (summary,
    the SuCo index)."""
    import dataclasses

    import numpy as np

    from repro_torch.core.config import suco_config
    from repro_torch.core.taco import query_with_stats

    summary = {"searches": []}
    gather = taco_index.replace_cfg(rerank="gather")
    gather.search(queries[:8])  # warm-up
    runs, launches = run_path(torch, "gather",
                              lambda: search_runs(torch, gather, queries, SETTINGS),
                              expect={"l2dist": 3 * len(SETTINGS)})
    summary["launches"] = launches
    profile_search(torch, gather, queries, "gather")
    for (k, sel), run in runs.items():
        row = against_plain(torch, gather, queries, gt, run, k, sel, "gather")
        if sel == "query_aware":
            kept = ~run["stats"]["truncated"]
            masked_ids = masked_runs[(k, sel)]["ids"]
            same = float(np.mean(run["ids"][kept] == masked_ids[kept]))
            row["ids_same_as_masked_full"] = same
            check(same >= 0.999, f"gather ids same as masked-full {same} < 0.999 k={k}")
        row["config"] = "taco"
        print(f"gather: search {json.dumps(row)}", flush=True)
        summary["searches"].append(row)
    del runs
    torch.cuda.empty_cache()

    cfg = suco_config(n_subspaces=6, n_clusters=1024, alpha=0.05, beta=0.005, k=10,
                      use_kernels=True)
    (suco, build_s), build_launches = run_path(
        torch, "build", lambda: build_index(torch, corpus_np, cfg, "gather suco"),
        expect={"kmeans_assign": cfg.kmeans_iters + 1})
    summary.update(suco_build_s=build_s, suco_build_launches=build_launches)
    suco.search(queries[:8])
    settings = [(k, "fixed") for k in (10, 100)]
    runs, launches = run_path(torch, "gather", lambda: search_runs(torch, suco, queries, settings),
                              expect={"l2dist": 3 * len(settings)})
    summary["suco_launches"] = launches
    for (k, sel), run in runs.items():
        row = against_plain(torch, suco, queries, gt, run, k, sel, "gather suco")
        row["config"] = "suco"
        print(f"gather: search {json.dumps(row)}", flush=True)
        summary["searches"].append(row)
    del runs
    torch.cuda.empty_cache()

    # activations: heap and linear must find sort's tau on the card; tau and
    # the retrieved counts are internal stats, so read from query_with_stats
    head = queries[:100]
    _ids, _d, want = query_with_stats(gather.sc_index, head, gather.cfg, k=10)
    summary["activations"] = {}
    for method in ("heap", "linear"):
        cfg = dataclasses.replace(gather.cfg, activation=method)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _ids, _d, got = query_with_stats(gather.sc_index, head, cfg, k=10)
        torch.cuda.synchronize()
        row = dict(seconds=time.perf_counter() - t0,
                   taus_equal=bool(torch.equal(got["taus"], want["taus"])),
                   retrieved_differ=int((got["retrieved"] != want["retrieved"]).sum()),
                   problems=int(want["taus"].numel()))
        print(f"gather: activation {method} vs sort, first 100 queries: {json.dumps(row)}",
              flush=True)
        check(row["taus_equal"], f"activation {method}: tau differs from sort")
        summary["activations"][method] = row
    return summary, suco


def save_and_load(torch, index, label: str) -> tuple:
    """(loaded index, row): AnnIndex.save to a temporary directory and
    AnnIndex.load on the card, host clock, every array checked bitwise."""
    from repro_torch.ann import AnnIndex
    from repro_torch.ann.persistence import leaves_of

    with tempfile.TemporaryDirectory() as tmp:
        path = str(Path(tmp) / "index")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        index.save(path)
        save_s = time.perf_counter() - t0
        disk = sum(f.stat().st_size for f in Path(path).rglob("*") if f.is_file())
        t0 = time.perf_counter()
        loaded = AnnIndex.load(path)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
    got, want = leaves_of(loaded.sc_index), leaves_of(index.sc_index)
    check(len(got) == len(want), f"persist {label}: leaf count")
    check(all(g.device == w.device and torch.equal(g, w) for g, w in zip(got, want)),
          f"persist {label}: a reloaded array differs")
    check(loaded.cfg == index.cfg, f"persist {label}: config differs")
    row = dict(save_s=save_s, load_s=load_s, bytes_on_disk=disk, leaves=len(got))
    print(f"persist {label}: {json.dumps(row)}", flush=True)
    return loaded, row


def phase_persist(torch, taco_index, suco_index, queries) -> dict:
    """Phase 7: save and reload the TaCo index (and the SuCo index, which
    carries a dim_perm); one batch of masked-full and one of gather, k = 10,
    query-aware, on the reloaded index must equal the in-memory index's bit
    for bit, and a repeated batch must hit the searcher's cache."""
    import numpy as np

    summary = {}
    loaded, summary["taco"] = save_and_load(torch, taco_index, "taco")
    reruns = ("masked_full", "gather")
    view = loaded.replace_cfg(selection="query_aware")
    results, launches = run_path(
        torch, "persist", lambda: [view.search(queries, k=10, rerank=r) for r in reruns],
        expect={"l2dist": len(reruns)})
    summary["launches"] = launches
    for rerank, (ids, dists) in zip(reruns, results):
        want_ids, want_d = taco_index.replace_cfg(selection="query_aware").search(
            queries, k=10, rerank=rerank)
        check(np.array_equal(ids, want_ids) and
              np.array_equal(dists.view(np.uint32), want_d.view(np.uint32)),
              f"persist: reloaded {rerank} results differ from the built index")
    searcher = view._default_searcher()
    before = dict(searcher.compile_counts)
    view.search(queries, k=10, rerank="masked_full")
    check(searcher.compile_counts == before and set(before.values()) == {1},
          "persist: a repeated batch shape missed the searcher's cache")
    summary["compile_counts"] = {f"bucket {b}, k {k}, rerank {c.rerank}": n
                                 for (b, k, c), n in before.items()}
    print(f"persist: compile_counts {json.dumps(summary['compile_counts'])}", flush=True)

    suco, summary["suco"] = save_and_load(torch, suco_index, "suco")
    check(suco.sc_index.transform is None and suco.sc_index.dim_perm is not None,
          "persist suco: dim_perm / transform structure")
    for got, want in zip(suco.search(queries, k=10), suco_index.search(queries, k=10)):
        check(np.array_equal(got.view(np.uint32), want.view(np.uint32)),
              "persist suco: reloaded results differ")
    return summary


def brute_force_top10(torch, corpus, queries):
    from repro_torch.utils import pairwise_sq_dists

    gt = []
    for lo in range(0, queries.shape[0], 100):
        d = pairwise_sq_dists(queries[lo:lo + 100], corpus)
        gt.append(torch.topk(d, 10, dim=1, largest=False).indices)
    return torch.cat(gt).cpu().numpy()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=1_000_000,
                    help="corpus size (cut it for a quick first check of a new kernel)")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    root = Path(__file__).resolve().parent
    if not (root / "src" / "repro_torch").is_dir():
        print("chip_smoke: run from a checkout of the repository", file=sys.stderr)
        return 1
    sys.path.insert(0, str(root / "src"))
    import numpy as np

    from repro_torch.data import gmm_dataset, make_queries
    from repro_torch.kernels import cuda

    # 1. device
    line = card_line()
    print(f"device: {line}", flush=True)
    # 2. build
    t0 = time.perf_counter()
    reports = cuda.build_all()
    build_kernels_s = time.perf_counter() - t0
    print(f"build: kernels in {build_kernels_s:.2f} s", flush=True)
    ptxas = {}
    for name, log in reports.items():
        ptxas[name] = [ln.strip() for ln in log.splitlines()
                       if "registers" in ln or "spill" in ln or "wgmma" in ln
                       or "Compiling entry" in ln]
        for ln in ptxas[name]:
            print(f"build: {name}: {ln}", flush=True)

    t0 = time.perf_counter()
    full = gmm_dataset(args.n + QUERIES, 128, seed=0)
    corpus_np, queries_np = make_queries(full, QUERIES)
    del full
    print(f"data: {corpus_np.shape} corpus, {queries_np.shape} queries in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    rng = np.random.default_rng(0)
    corpus = torch.as_tensor(corpus_np).cuda()
    queries = torch.as_tensor(queries_np).cuda()
    gt = brute_force_top10(torch, corpus, queries)

    # 3. ANN kernels against plain versions, 4. flash attention
    kernels = phase_kernels(torch, corpus, queries, rng)
    del corpus
    torch.cuda.empty_cache()
    flash = phase_flash(torch)
    flash["ptxas"] = ptxas["flash_attention"]
    kernels["masked_rerank"]["ptxas"] = ptxas["masked_rerank"]
    for name in ("flash_attention", "masked_rerank"):
        check(all("0 bytes spill stores, 0 bytes spill loads" in ln
                  for ln in ptxas[name] if "spill" in ln), f"{name}: ptxas reports spills")
    kernels["flash_attention"] = flash["cases"][0]
    # 5. masked-full path, 6. gather path, 7. save / load
    index, masked, masked_runs = phase_masked(torch, corpus_np, queries, gt)
    gather, suco = phase_gather(torch, index, corpus_np, queries, gt, masked_runs)
    del masked_runs
    persist = phase_persist(torch, index, suco, queries)

    # 8. summary: each kernel's launches over every path run above
    launches = {name: 0 for name in SOURCES}
    for counts in (flash["launches"], masked["build_launches"], masked["launches"],
                   gather["launches"], gather["suco_build_launches"], gather["suco_launches"],
                   persist["launches"]):
        for name, count in counts.items():
            launches[name] += count
    rows = []
    for name, (src, replaces) in SOURCES.items():
        r = kernels[name]
        rows.append({"name": name, "route": "cuda", "source": src, "replaces": replaces,
                     "launches": launches[name],
                     "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                     "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                     "bound_by": r["bound_by"], "library_ms": r["library_ms"]})
    out = root / "chiprun_out" / "chip_smoke.json"
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps({"device": line, "build_kernels_s": build_kernels_s,
                               "kernels": kernels, "flash": flash, "masked": masked,
                               "gather": gather, "persist": persist}, indent=1))
    print(card_line(), flush=True)
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}),
          flush=True)
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        sys.exit(1)
