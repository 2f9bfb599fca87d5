#!/usr/bin/env python3
"""What holds kmeans_assign's tiled path (the TF32 screen and its exact
rechecks) back, measured on the card.

    python3 scripts/kmeans_screen_variants.py

The tiled path (``src/repro_torch/csrc/kmeans_assign.cu``, ``tiled::``)
assigns IVF's 10^6 x 128 corpus to 1024 lists. This script builds, under
``build/``, variants of that source by text substitution and times each
beside the kernel, in turns (kernel, variants, variants, kernel), on the
``gmm_dataset`` corpus against 1024 of its rows:

  no_rechecks — the exact rechecks skipped (the screen, the epilogue and
                the candidate queue alone);
  no_queue    — no candidate queued either (the screen and the epilogue's
                distances and window alone);
  screen_only — the epilogue skipped too (the points' load, the centroid
                ring and the wgmma products alone);
  phases      — the kernel itself with clock64() around each phase of a
                warp (printed as cycles a warp a tile). The turn's named
                barrier blocks lazily (BAR.SYNC.DEFER_BLOCKING), so most of
                a warpgroup's wait for its turn shows under data_wait, at
                the first instruction after it that must wait.

The first three do not compute the kernel's function: they are timed only,
to split the kernel's time. The variants are measurements only: the port never builds
or calls them. Needs a CUDA card and nvcc.
"""
from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
RECHECK = "      recheck(static_cast<int>(item & 255), static_cast<int>(item >> 8));\n"
PUSH = "      const unsigned int ballot = __ballot_sync(0xffffffffu, mine != 0);\n"
EPILOGUES = (("    epilogue(t, acc, tv);\n", ""),)
VARIANTS = {
    "no_rechecks": ((RECHECK, ""),),
    "no_queue": ((PUSH, "      const unsigned int ballot = 0u * (mine != 0);\n"),),
    "screen_only": EPILOGUES,
}
#: the kernel with clock64() around each phase of a warp, summed over the
#: launch into the recheck counter's neighbours: the block's load, the turn
#: (named barrier), the wait for the tile's data, the wgmma issue, the
#: wgmma wait, the epilogue, the final flush
PHASES = ("load", "turn", "data_wait", "wgmma_issue", "mma_wait", "epilogue", "flush")
TIMED = (
    ("  const int tid = threadIdx.x, pair = blockIdx.y, tiles = k_pad / N;\n",
     "  const int tid = threadIdx.x, pair = blockIdx.y, tiles = k_pad / N;\n"
     "  const long long c_start = clock64();\n"),
    ("  const int wg = tid / 128, lane = tid % 32;\n",
     "  const int wg = tid / 128, lane = tid % 32;\n"
     "  long long ph[7] = {clock64() - c_start, 0, 0, 0, 0, 0, 0};\n"),
    ("    mbar_wait(full + 8 * s, (t / STAGES) & 1);\n",
     "    const long long cw = clock64();\n    mbar_wait(full + 8 * s, (t / STAGES) & 1);\n"
     "    ph[2] += clock64() - cw;\n"),
    ("    if (t > 0 || wg > 0) bar_sync(mine_bar);\n",
     "    long long c0 = clock64();\n    if (t > 0 || wg > 0) bar_sync(mine_bar);\n"
     "    long long c1 = clock64();\n    ph[1] += c1 - c0;\n    const long long d0 = ph[2];\n"),
    ("    issue(t, acc, tv);\n",
     "    issue(t, acc, tv);\n    c0 = clock64();\n    ph[3] += c0 - c1 - (ph[2] - d0);\n"),
    ("    fence_regs(acc);\n    release(t);\n",
     "    fence_regs(acc);\n    c1 = clock64();\n    ph[4] += c1 - c0;\n    release(t);\n"),
    ("    epilogue(t, acc, tv);\n    __syncwarp();\n",
     "    epilogue(t, acc, tv);\n    __syncwarp();\n    ph[5] += clock64() - c1;\n"),
    ("  if (wg == 0) bar_sync(mine_bar);  // the last warpgroup's last arrival\n  flush();\n",
     "  if (wg == 0) bar_sync(mine_bar);  // the last warpgroup's last arrival\n"
     "  const long long c5 = clock64();\n  flush();\n  ph[6] = clock64() - c5;\n"
     "  if (lane == 0)\n    for (int i = 0; i < 7; ++i)\n"
     "      atomicAdd(rechecks + 1 + i, static_cast<unsigned long long>(ph[i]));\n"),
)
VARIANTS["phases"] = TIMED


def build_variants(cuda) -> dict:
    """Compile every variant in parallel; return name -> its C entry. The
    substitutions apply to the resident-points tiled path (``tiled::``),
    the source before the wide path's namespace."""
    src, sep, wide = (cuda.CSRC / "kmeans_assign.cu").read_text().partition("\nnamespace wide {")
    out_dir = ROOT / "build" / "kmeans_screen_variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, subs in VARIANTS.items():
        text = src
        for old, new in subs:
            if text.count(old) != 1:
                raise RuntimeError(f"{name}: the kernel source changed near {old[:40]!r}")
            text = text.replace(old, new)
        (out_dir / f"{name}.cu").write_text(text + sep + wide)
        procs[name] = subprocess.Popen(
            [cuda._nvcc(), *cuda.NVCC_FLAGS, "-I", str(cuda.CSRC), "-o",
             str(out_dir / f"{name}.so"), str(out_dir / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    fns = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"{name}: nvcc failed\n{log}")
        fns[name] = ctypes.CDLL(str(out_dir / f"{name}.so")).kmeans_assign_f32
    return fns


def main() -> int:
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import numpy as np
    import torch

    import chip_smoke
    from repro_torch.data import gmm_dataset
    from repro_torch.kernels import cuda
    from repro_torch.kernels import kmeans_assign as K

    if not torch.cuda.is_available():
        print("kmeans_screen_variants: no CUDA device is available", file=sys.stderr)
        return 1
    print(f"device: {chip_smoke.card_line()}", flush=True)
    fns = build_variants(cuda)
    for fn in fns.values():
        fn.argtypes = K._ARGS
        fn.restype = ctypes.c_int

    n, w, k = 10 ** 6, 128, 1024
    x = torch.as_tensor(gmm_dataset(n, w, seed=0)).cuda()
    rng = np.random.default_rng(0)
    c = x[torch.as_tensor(rng.choice(n, k, replace=False), device="cuda")].contiguous()
    floats = K.tiled_scratch_floats(1, k, w)
    scratch = torch.empty((floats,), dtype=torch.float32, device="cuda")
    rechecks = torch.zeros((1 + len(PHASES),), dtype=torch.int64, device="cuda")

    def run(fn):
        assign = torch.empty((n,), dtype=torch.int32, device="cuda")
        dmin = torch.empty((n,), dtype=torch.float32, device="cuda")
        rc = fn(cuda.ptr(x), cuda.ptr(c), cuda.ptr(assign), cuda.ptr(dmin), n, k, w,
                *K.screen_window(w), cuda.ptr(scratch), floats, cuda.ptr(rechecks),
                cuda.stream(x.device))
        if rc != 0:
            raise RuntimeError(f"variant: CUDA error {rc}")
        return assign, dmin

    row = {"shape": f"x ({n}, {w}), c ({k}, {w})",
           "kernel_ms": [chip_smoke.timed(torch, lambda: K.kmeans_assign_cuda(x, c), 10)]}
    for _ in range(2):
        for name, fn in fns.items():
            row.setdefault(f"{name}_ms", []).append(chip_smoke.timed(torch, lambda: run(fn), 10))
    row["kernel_ms"].append(chip_smoke.timed(torch, lambda: K.kmeans_assign_cuda(x, c), 10))
    # one timed launch: each phase's cycles a consumer warp a tile
    rechecks.zero_()
    run(fns["phases"])
    torch.cuda.synchronize()
    warps_tiles = -(-n // K.TILE_POINTS) * (K.TILE_POINTS // 16) * (k // K.TILE_CENTROIDS)
    row["phase_cycles_per_warp_tile"] = {
        name: int(v) / warps_tiles for name, v in zip(PHASES, rechecks[1:].tolist())}
    print(f"ivf: {json.dumps(row)}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
