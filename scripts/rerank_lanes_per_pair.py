#!/usr/bin/env python3
"""What eight lanes a pair would gain the masked re-rank kernel's pass a,
measured on the card.

    python3 scripts/rerank_lanes_per_pair.py

The kernel (``src/repro_torch/csrc/masked_rerank.cu``) computes each queued
(point, query) pair's dot product on one lane, so a warp's float4 load
touches 32 rows (32 L1 wavefronts for 512 useful bytes). This script builds,
under ``build/``, a variant of that source in which eight lanes share a pair
(a warp's load then reads four whole 128-byte lines) and three shuffles sum
their parts; the filter and the locked heap insert are the kernel's own. It
checks the variant bit for bit against the plain version on integer inputs,
then times kernel and variant in turns (kernel, variant, variant, kernel) at
``chip_smoke.py``'s kernels-phase shape: 10^6 x 128, 1000 queries, N_s 6,
K 1024, k = 10 and 100. The variant is a measurement only: the port never
builds or calls it. Needs a CUDA card and nvcc.
"""
from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SCORE_HEAD = "  auto score = [&](int p, int s, bool valid) {\n"
SCORE_TAIL = "    while (__any_sync(kFull, cand)) {\n"
# the query rows in shared memory and d % 4 == 0: the shape timed here
VARIANT_SCORE = """  auto score = [&](int p, int s, bool valid, int m) {
    float dot = 0.f;
    const int sub = lane % 8, j = lane / 8;
    for (int r = 0; r * 4 < m; ++r) {
      const int src = r * 4 + j;
      const int pp = __shfl_sync(kFull, p, src);
      const int ss = __shfl_sync(kFull, s, src);
      float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
      if (src < m) {
        const float4* x4 = reinterpret_cast<const float4*>(data + static_cast<size_t>(pp) * d);
        const float4* q4 = reinterpret_cast<const float4*>(qs + ss * qstride);
#pragma unroll 4
        for (int t = sub; t < d / 4; t += 8) {
          const float4 qa = q4[t];
          const float4 xb = __ldg(x4 + t);
          acc.x = fmaf(qa.x, xb.x, acc.x);
          acc.y = fmaf(qa.y, xb.y, acc.y);
          acc.z = fmaf(qa.z, xb.z, acc.z);
          acc.w = fmaf(qa.w, xb.w, acc.w);
        }
      }
      float part = (acc.x + acc.y) + (acc.z + acc.w);
      part += __shfl_xor_sync(kFull, part, 4);
      part += __shfl_xor_sync(kFull, part, 2);
      part += __shfl_xor_sync(kFull, part, 1);
      const float v = __shfl_sync(kFull, part, (lane & 3) * 8);
      if ((lane >> 2) == r) dot = v;
    }
    bool cand = false;
    Entry e = 0;
    if (valid) {
      e = make_entry(fmaxf((qn[s] - 2.0f * dot) + __ldg(norms + p), 0.0f), p);
      cand = entry_less(e, *reinterpret_cast<volatile Entry*>(hp(s)));
    }
"""
CALLS = (("score(pr.x, pr.y, true);", "score(pr.x, pr.y, true, 32);"),
         ("score(pr.x, pr.y, lane < m);", "score(pr.x, pr.y, lane < m, m);"))


def build_variant(cuda) -> ctypes.CDLL:
    src = (cuda.CSRC / "masked_rerank.cu").read_text()
    if src.count(SCORE_HEAD) != 1 or src.count(SCORE_TAIL) != 1:
        raise SystemExit("rerank_lanes_per_pair: the kernel's score lambda was not found once")
    a, b = src.index(SCORE_HEAD), src.index(SCORE_TAIL)
    src = src[:a] + VARIANT_SCORE + src[b:]
    for old, new in CALLS:
        src = src.replace(old, new)
    cuda.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    variant = cuda.BUILD_DIR / "masked_rerank_octets.cu"
    variant.write_text(src.replace('#include "collision.cuh"',
                                   f'#include "{cuda.CSRC / "collision.cuh"}"'))
    lib_path = variant.with_suffix(".so")
    out = subprocess.run([cuda._nvcc(), *cuda.NVCC_FLAGS, "-o", str(lib_path), str(variant)],
                         check=True, capture_output=True, text=True)
    for ln in (out.stdout + out.stderr).splitlines():
        if "registers" in ln or "spill" in ln:
            print(f"variant ptxas: {ln.strip()}", flush=True)
    return ctypes.CDLL(str(lib_path))


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("rerank_lanes_per_pair: no CUDA device is available", file=sys.stderr)
        return 1
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import chip_smoke
    from repro_torch.core.activation import activation_taus
    from repro_torch.core.selection import query_aware_threshold
    from repro_torch.data import gmm_dataset, make_queries
    from repro_torch.kernels import cuda
    from repro_torch.kernels.masked_rerank import (
        _ARGS,
        masked_rerank_cuda,
        masked_rerank_plain,
        rerank_geometry,
    )
    from repro_torch.kernels.schist import collision_bits, collision_table, schist_plain

    print(f"device: {chip_smoke.card_line()}", flush=True)
    fn = build_variant(cuda).masked_rerank_f32
    fn.argtypes, fn.restype = _ARGS, ctypes.c_int

    def octets(bits, cells, thresh, queries, data, norms, k):
        q, d = queries.shape
        n = data.shape[0]
        _, n_sub, k2 = bits.shape
        lanes, warps, chunk, n_chunks, *_ = rerank_geometry(n, k, n_sub, k2, d)
        part = [torch.empty((q, n_chunks, k), dtype=dt, device=data.device)
                for dt in (torch.float32, torch.int32)]
        best = [torch.empty((q, k), dtype=dt, device=data.device)
                for dt in (torch.float32, torch.int32)]
        rc = fn(*(cuda.ptr(t) for t in (bits, cells, thresh, queries, data, norms)),
                ctypes.c_void_p(None), *(cuda.ptr(t) for t in (*part, *best)),
                ctypes.c_void_p(None), q, n, d, n_sub, k2, k, chunk, n_chunks, lanes, warps, 1,
                cuda.stream(data.device))
        if rc != 0:
            raise RuntimeError(f"octet variant: CUDA error {rc}")
        return best

    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    n_sub, q, sqrt_k, n = 6, chip_smoke.QUERIES, 32, 10 ** 6

    def T(a, dtype=None):
        return torch.as_tensor(a, dtype=dtype, device=dev)

    def case(data, qs):
        """chip_smoke's rerank_case: random cells, sort-activation taus at
        alpha 0.05, the query-aware threshold at beta 0.005."""
        n_ = data.shape[0]
        cells = T(rng.integers(0, sqrt_k ** 2, (n_sub, n_)), torch.int32)
        sizes = torch.stack([torch.bincount(cells[s].long(), minlength=sqrt_k ** 2)
                             for s in range(n_sub)]).to(torch.int32)
        d1s, d2s = (T(rng.uniform(0, 4, (n_sub, q, sqrt_k)).astype(np.float32)) for _ in range(2))
        taus, _ = activation_taus(d1s, d2s, sizes.reshape(n_sub, sqrt_k, sqrt_k), 0.05 * n_)
        bits = collision_bits(collision_table(d1s, d2s, taus))
        hist = schist_plain(bits, cells, n_sub + 1, q=q)
        thresh, _ = query_aware_threshold(hist, 0.005 * n_, n_sub)
        return bits, cells, thresh, qs, data, (data * data).sum(1)

    ok = True
    for k in (10, 100):
        ints = [T(rng.integers(-8, 9, shape).astype(np.float32)) for shape in ((65536, 128), (q, 128))]
        args = case(*ints)
        gd, gi = octets(*args, k)
        wd, wi = masked_rerank_plain(*args, k)
        exact = bool(torch.equal(gd, wd) and torch.equal(gi, wi))
        ok &= exact
        print(f"k={k}: integer inputs bitwise equal to the plain version: {exact}", flush=True)
    full = gmm_dataset(n + q, 128, seed=0)
    corpus_np, queries_np = make_queries(full, q)
    corpus, queries = T(corpus_np), T(queries_np)
    for k in (10, 100):
        args = case(corpus, queries)
        gd, gi = octets(*args, k)
        kd, ki = masked_rerank_cuda(*args, k)
        kernel = [chip_smoke.timed(torch, lambda: masked_rerank_cuda(*args, k), 5)]
        variant = [chip_smoke.timed(torch, lambda: octets(*args, k), 5) for _ in range(2)]
        kernel.append(chip_smoke.timed(torch, lambda: masked_rerank_cuda(*args, k), 5))
        fin = torch.isfinite(kd)
        row = dict(k=k, kernel_ms=kernel, octets_ms=variant,
                   ids_agree=float((gi == ki).float().mean()),
                   max_abs_diff=float((gd[fin] - kd[fin]).abs().max()))
        print(json.dumps(row), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
