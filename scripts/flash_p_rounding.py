#!/usr/bin/env python3
"""What one bf16 rounding of P would cost the bf16 flash kernel, measured on
the card.

    python3 scripts/flash_p_rounding.py

The kernel (``src/repro_torch/csrc/flash_attention.cu``) takes P into P.V as
two bf16 terms, hi = bf16(p) and lo = bf16(p - hi). This script builds,
under ``build/``, a variant of that source whose lo term is zero (P rounded
once to bf16), runs both on ``chip_smoke.py``'s bf16 flash cases (the same
seeded inputs) and prints, for each, the worst share of the allowance
against the plain version in f32 (``chip_smoke.FLASH_BF16_VS_F32``:
2^-7 |x| + 4e-5 per element) that each uses; 1.0 is the limit. The variant
is a measurement only: the port never builds or calls it. Needs a CUDA card
and nvcc.
"""
from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
LO_LINE = ("const __nv_bfloat162 lo = __floats2bfloat162_rn(x0 - __low2float(hi), "
           "x1 - __high2float(hi));")
LO_ZERO = "const __nv_bfloat162 lo = __floats2bfloat162_rn(0.f, 0.f);"


def build_variant(cuda) -> ctypes.CDLL:
    src = (cuda.CSRC / "flash_attention.cu").read_text()
    if src.count(LO_LINE) != 1:
        raise SystemExit("flash_p_rounding: the kernel's lo line was not found once")
    cuda.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    variant = cuda.BUILD_DIR / "flash_attention_single_p.cu"
    variant.write_text(src.replace(LO_LINE, LO_ZERO))
    lib_path = variant.with_suffix(".so")
    subprocess.run([cuda._nvcc(), *cuda.NVCC_FLAGS, "-o", str(lib_path), str(variant)],
                   check=True, capture_output=True, text=True)
    return ctypes.CDLL(str(lib_path))


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("flash_p_rounding: no CUDA device is available", file=sys.stderr)
        return 1
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import chip_smoke
    from repro_torch.kernels import cuda
    from repro_torch.kernels.flash_attention import (
        _ARGS,
        flash_attention_cuda,
        flash_attention_plain,
    )

    fn = build_variant(cuda).flash_attention_bf16
    fn.argtypes, fn.restype = _ARGS, ctypes.c_int

    def single(q, k, v, causal):
        out = torch.empty_like(q)
        bh, s, hd = q.shape
        rc = fn(cuda.ptr(q), cuda.ptr(k), cuda.ptr(v), cuda.ptr(out), bh, s, k.shape[1], hd,
                int(causal), hd ** -0.5, cuda.stream(q.device))
        if rc != 0:
            raise RuntimeError(f"single-rounding variant: CUDA error {rc}")
        return out

    rtol, atol = chip_smoke.FLASH_BF16_VS_F32
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = []
    # chip_smoke.phase_flash's inputs: every case drawn in order from one generator
    for label, bh, kv_heads, s, t, hd, causal, dtype in chip_smoke.FLASH_CASES:
        dt = getattr(torch, dtype)
        q = torch.randn((bh, s, hd), generator=gen, device="cuda").to(dt)
        k, v = (torch.randn((kv_heads, t, hd), generator=gen, device="cuda").to(dt)
                .repeat_interleave(bh // kv_heads, dim=0) for _ in range(2))
        if dtype != "bfloat16":
            continue
        want = flash_attention_plain(q.float(), k.float(), v.float(), causal)
        allowed = atol + rtol * want.abs()
        row = {"case": label}
        for name, f in (("hi_lo", flash_attention_cuda), ("single", single)):
            diff = (f(q, k, v, causal).float() - want).abs()
            row[f"share_of_allowed_vs_f32_{name}"] = float((diff / allowed).max())
            row[f"max_abs_err_vs_f32_{name}"] = float(diff.max())
            del diff
        print(f"p_rounding: {json.dumps(row)}", flush=True)
        rows.append(row)
        del q, k, v, want, allowed
        torch.cuda.empty_cache()
    print(chip_smoke.card_line(), flush=True)
    print(json.dumps({"p_rounding": rows}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
