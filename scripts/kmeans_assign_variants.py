#!/usr/bin/env python3
"""What holds the batched kmeans_assign kernel back, measured on the card.

    python3 scripts/kmeans_assign_variants.py

The kernel (``src/repro_torch/csrc/kmeans_assign.cu``) streams a build's 12
(subspace, half) pairs of 10^6 points past 32 centroids each. This script
builds, under ``build/``, variants of that source by text substitution and
times each beside the kernel, in turns (kernel, variants, variants, kernel),
at the build's shapes: TaCo's halves of 4 floats and SuCo's of 10/11, 11/12
padded to 12.

  unroll4 — the centroid loop unrolled four times (less loop overhead);
  pts8    — eight points a thread at w <= 4 (each centroid read from shared
            memory once for eight points instead of four);
  both    — unroll4 and pts8 together;
  stream  — the memory floor: the same loads and stores with no centroid
            loop (each point's |x|^2 is stored, so the loads stay), which is
            not the kernel's function and is only timed.

Every variant but ``stream`` must equal the kernel bit for bit on float
inputs. The variants are measurements only: the port never builds or calls
them. Needs a CUDA card and nvcc.
"""
from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
LOOP = "  for (int j = 0; j < k; ++j) {\n"
PTS = "  return MAXW <= 16 ? 4 : (MAXW <= 32 ? 2 : 1);\n"
STORE = "      dmin[base + p] = best_d[i];\n"
VARIANTS = {
    "unroll4": ((LOOP, "#pragma unroll 4\n" + LOOP),),
    "pts8": ((PTS, "  return MAXW <= 4 ? 8 : (MAXW <= 16 ? 4 : (MAXW <= 32 ? 2 : 1));\n"),),
    "both": ((LOOP, "#pragma unroll 4\n" + LOOP),
             (PTS, "  return MAXW <= 4 ? 8 : (MAXW <= 16 ? 4 : (MAXW <= 32 ? 2 : 1));\n")),
    "stream": ((LOOP, "  for (int j = 0; j < 0; ++j) {\n"),
               (STORE, "      dmin[base + p] = best_d[i] + x2[i];\n")),
}


def build_variants(cuda) -> dict:
    """Compile every variant in parallel; return name -> its C entry."""
    src = (cuda.CSRC / "kmeans_assign.cu").read_text()
    out_dir = ROOT / "build" / "kmeans_assign_variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, subs in VARIANTS.items():
        text = src
        for old, new in subs:
            if text.count(old) != 1:
                raise RuntimeError(f"{name}: the kernel source changed near {old[:40]!r}")
            text = text.replace(old, new)
        (out_dir / f"{name}.cu").write_text(text)
        procs[name] = subprocess.Popen(
            [cuda._nvcc(), *cuda.NVCC_FLAGS, "-I", str(cuda.CSRC), "-o",
             str(out_dir / f"{name}.so"), str(out_dir / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    fns = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"{name}: nvcc failed\n{log}")
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"{name} ptxas: {line.strip()}", flush=True)
        fn = ctypes.CDLL(str(out_dir / f"{name}.so")).kmeans_assign_pairs_f32
        fns[name] = fn
    return fns


def main() -> int:
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import torch

    import chip_smoke
    from repro_torch.kernels import cuda
    from repro_torch.kernels import kmeans_assign as K

    if not torch.cuda.is_available():
        print("kmeans_assign_variants: no CUDA device is available", file=sys.stderr)
        return 1
    print(f"device: {chip_smoke.card_line()}", flush=True)
    fns = build_variants(cuda)
    for fn in fns.values():
        fn.argtypes = K._PAIRS_ARGS
        fn.restype = ctypes.c_int

    def run(fn, xs, cs):
        n_pairs, n, w = xs.shape
        assign = torch.empty((n_pairs, n), dtype=torch.int32, device=xs.device)
        dmin = torch.empty((n_pairs, n), dtype=torch.float32, device=xs.device)
        rc = fn(cuda.ptr(xs), cuda.ptr(cs), cuda.ptr(assign), cuda.ptr(dmin), n_pairs, n,
                cs.shape[1], w, 0.0, 0.0, None, 0, None, cuda.stream(xs.device))
        if rc != 0:
            raise RuntimeError(f"variant: CUDA error {rc}")
        return assign, dmin

    gen = torch.Generator(device="cuda").manual_seed(0)
    ok = True
    for label, dims in (("taco", [4] * 12), ("suco", [10, 11] * 5 + [11, 12])):
        n, k, w = 10 ** 6, 32, -(-max(dims) // 4) * 4
        xs = torch.zeros((len(dims), n, w), device="cuda")
        cs = torch.zeros((len(dims), k, w), device="cuda")
        for p, d in enumerate(dims):
            xs[p, :, :d] = torch.randn((n, d), generator=gen, device="cuda")
            cs[p, :, :d] = torch.randn((k, d), generator=gen, device="cuda")
        want = K.kmeans_assign_pairs_cuda(xs, cs, dims)
        row = {"shape": f"{len(dims)} pairs, x ({n}, {w}) (widths {dims}), c ({k}, {w})",
               "kernel_ms": [chip_smoke.timed(torch, lambda: K.kmeans_assign_pairs_cuda(xs, cs),
                                              100)]}
        for rep in range(2):
            for name, fn in fns.items():
                row.setdefault(f"{name}_ms", []).append(
                    chip_smoke.timed(torch, lambda: run(fn, xs, cs), 100))
        row["kernel_ms"].append(chip_smoke.timed(torch, lambda: K.kmeans_assign_pairs_cuda(xs, cs),
                                                 100))
        for name, fn in fns.items():
            if name == "stream":
                continue
            got = run(fn, xs, cs)
            same = bool(torch.equal(got[0], want[0]) and torch.equal(
                got[1].view(torch.int32), want[1].view(torch.int32)))
            row[f"{name}_bitwise"] = same
            ok &= same
        print(f"{label}: {json.dumps(row)}", flush=True)
        del xs, cs, want
        torch.cuda.empty_cache()
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
