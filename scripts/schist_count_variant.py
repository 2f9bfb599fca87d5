#!/usr/bin/env python3
"""What a cheaper level count would gain the schist kernel, measured on the
card.

    python3 scripts/schist_count_variant.py

The kernel (``src/repro_torch/csrc/schist.cu``) transposes each of a warp
step's T x NP bit-planes with five shuffles and counts every level, 0 to
N_s, with one popcount each. This script builds, under ``build/``, a
variant of that source that (1) moves two planes' halves in one shuffle
(each lane sends only the half of a word its partner keeps, so two planes
fit in one 32-bit shuffle: 7.5 shuffles a tile step instead of 15) and (2)
takes level 0 as the points counted less the other levels, since every
query's row sums to its points (one popcount fewer a tile step). It checks
the variant bit for bit against the plain version on ``chip_smoke.py``'s
schist shapes, then times kernel and variant in turns (kernel, variant,
variant, kernel) at the kernels-phase shape: Q 1000, n 10^6, N_s 6, K 1024.
The variant is a measurement only: the port never builds or calls it.
Needs a CUDA card and nvcc.
"""
from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
HELPER = """// Transposes every plane, two planes a shuffle: a lane sends its partner
// the half of A its partner keeps, with the same half of B rotated into the
// other half of the word.
template <int T, int NP>
__device__ __forceinline__ void transpose_packed(uint32_t (&x)[T][NP],
                                                 const Transpose32& tr) {
  constexpr int N = T * NP;
#pragma unroll
  for (int i = 0; i < 5; ++i) {
    const int s = 16 >> i;
    const uint32_t keep = tr.keep[i];
    const int rot = tr.rot[i];
#pragma unroll
    for (int f = 0; f + 1 < N; f += 2) {
      uint32_t& a = x[f / NP][f % NP];
      uint32_t& b = x[(f + 1) / NP][(f + 1) % NP];
      const uint32_t sent = (a & ~keep) | (__funnelshift_l(b, b, 32 - rot) & keep);
      const uint32_t got = __shfl_xor_sync(kFull, sent, s);
      a = (a & keep) | (__funnelshift_l(got, got, rot) & ~keep);
      b = (b & keep) | (got & ~keep);
    }
    if constexpr (N % 2 == 1) {
      uint32_t& a = x[(N - 1) / NP][(N - 1) % NP];
      const uint32_t other = __shfl_xor_sync(kFull, a, s);
      a = (a & keep) | (__funnelshift_l(other, other, rot) & ~keep);
    }
  }
}

"""
LEVEL0 = """#pragma unroll
    for (int t = 0; t < T; ++t) {
      int rest = 0;
#pragma unroll
      for (int l = 1; l < kLv; ++l)
        if (l <= n_sub) rest += cnt[t][l];
      cnt[t][0] = points - rest;
    }
"""
FLUSH_LOOP = """#pragma unroll
    for (int t = 0; t < T; ++t)
#pragma unroll
      for (int l = 0; l < kLv; ++l) {
        if (l <= n_sub) {
          const int v = cnt[t][l] - (l == 0 ? empty : 0);"""
SUBSTITUTIONS = (
    ("// A warp's place in its block's walk", HELPER + "// A warp's place in its block's walk"),
    ("    transpose(planes);\n", "    transpose_packed(planes, transpose);\n"),
    ("      for (int l = 0; l < kLv; ++l) {\n        if (l <= n_sub) {\n          uint32_t m = kFull;",
     "      for (int l = 1; l < kLv; ++l) {\n        if (l <= n_sub) {\n          uint32_t m = kFull;"),
    ("  int empty = 0;  // lane slots without a point: SC 0 for every query",
     "  int points = 0;  // points this lane's warp counted in the current group"),
    ("    empty += 32 - __popc(__ballot_sync(kFull, valid));",
     "    points += __popc(__ballot_sync(kFull, valid));"),
    (FLUSH_LOOP, LEVEL0 + FLUSH_LOOP.replace(" - (l == 0 ? empty : 0)", "")),
    ("    empty = 0;\n", "    points = 0;\n"),
)


def build_variant(cuda) -> ctypes.CDLL:
    src = (cuda.CSRC / "schist.cu").read_text()
    for old, new in SUBSTITUTIONS:
        if src.count(old) != 1:
            raise RuntimeError(f"variant: the kernel source changed near {old[:40]!r}")
        src = src.replace(old, new)
    out_dir = ROOT / "build" / "schist_count_variant"
    out_dir.mkdir(parents=True, exist_ok=True)
    (out_dir / "variant.cu").write_text(src)
    lib = out_dir / "variant.so"
    proc = subprocess.run([cuda._nvcc(), *cuda.NVCC_FLAGS, "-I", str(cuda.CSRC), "-o", str(lib),
                           str(out_dir / "variant.cu")], capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"variant: nvcc failed\n{proc.stdout}{proc.stderr}")
    for line in proc.stdout.splitlines() + proc.stderr.splitlines():
        if "registers" in line or "spill" in line:
            print(f"variant ptxas: {line.strip()}", flush=True)
    return ctypes.CDLL(str(lib))


def main() -> int:
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import numpy as np
    import torch

    import chip_smoke
    from repro_torch.kernels import cuda
    from repro_torch.kernels import schist as S

    if not torch.cuda.is_available():
        print("schist_count_variant: no CUDA device is available", file=sys.stderr)
        return 1
    print(f"device: {chip_smoke.card_line()}", flush=True)
    fn = build_variant(cuda).schist_i32
    fn.argtypes = S._ARGS
    fn.restype = ctypes.c_int

    def variant(bits, cells, n_levels, *, q):
        n_sub, k2 = bits.shape[1], bits.shape[2]
        tiles, warps, smem, *_ = S.schist_geometry(q, n_sub, k2)
        out = torch.empty((q, n_levels), dtype=torch.int32, device=bits.device)
        rc = fn(cuda.ptr(bits), cuda.ptr(cells), cuda.ptr(out), q, cells.shape[1], n_sub, k2,
                tiles, warps, S.CHUNK, smem, 0, 1, cuda.stream(bits.device))
        if rc != 0:
            raise RuntimeError(f"variant: CUDA error {rc}")
        return out

    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    ok = True
    for n_s, q, k2, n, fill in chip_smoke.SCHIST_CASES:
        qt = (q + 31) // 32
        if fill == "random":
            words = rng.integers(-2 ** 31, 2 ** 31, (qt, n_s, k2))
        else:
            words = np.full((qt, n_s, k2), -1 if fill == "ones" else 0)
        bits = torch.as_tensor(words, dtype=torch.int32, device=dev)
        cells = torch.as_tensor(rng.integers(0, k2, (n_s, n)), dtype=torch.int32, device=dev)
        same = bool(torch.equal(variant(bits, cells, n_s + 1, q=q),
                                S.schist_plain(bits, cells, n_s + 1, q=q)))
        ok &= same
        print(f"{(n_s, q, k2, n, fill)}: bitwise equal to the plain version: {same}", flush=True)
    n_s, q, k2, n = 6, chip_smoke.QUERIES, 1024, 10 ** 6
    table = torch.as_tensor(rng.random((n_s, q, k2)) < 0.05, device=dev)
    bits = S.collision_bits(table)
    cells = torch.as_tensor(rng.integers(0, k2, (n_s, n)), dtype=torch.int32, device=dev)
    same = bool(torch.equal(variant(bits, cells, n_s + 1, q=q),
                            S.schist_cuda(bits, cells, n_s + 1, q=q)))
    ok &= same
    kernel = [chip_smoke.timed(torch, lambda: S.schist_cuda(bits, cells, n_s + 1, q=q), 20)]
    timed = [chip_smoke.timed(torch, lambda: variant(bits, cells, n_s + 1, q=q), 20)
             for _ in range(2)]
    kernel.append(chip_smoke.timed(torch, lambda: S.schist_cuda(bits, cells, n_s + 1, q=q), 20))
    print(json.dumps(dict(shape=f"Q {q}, n {n}, N_s {n_s}, K {k2}", kernel_ms=kernel,
                          variant_ms=timed, equal_to_kernel=same,
                          geometry=S.schist_geometry(q, n_s, k2))), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
