"""Fused softmax attention, forward: the CUDA kernel
(``csrc/flash_attention.cu``) and its plain version
(:func:`repro_torch.kernels.ref.flash_attention_ref`).

Both take q (BH, S, hd) and k, v (BH, T, hd), all float32 or all bfloat16,
and return softmax(q k^T * hd^-1/2) v (BH, S, hd) in q's dtype, accumulated
in float32. ``causal`` keeps key position <= query position, top-left
aligned (also when S != T).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import cuda
from repro_torch.kernels.ref import flash_attention_ref as flash_attention_plain

_ARGS = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_float, ctypes.c_void_p]
#: largest head dimension the kernel takes (its accumulator lives in registers)
MAX_HEAD_DIM = 128
_SYMBOLS = {torch.float32: "flash_attention_f32", torch.bfloat16: "flash_attention_bf16"}

__all__ = ["flash_attention_cuda", "flash_attention_plain"]


def flash_attention_cuda(q, k, v, causal: bool = True) -> torch.Tensor:
    """Kernel launch: (BH, S, hd) in q's dtype. q, k, v contiguous, on one
    card, one dtype (float32 or bfloat16); S, T >= 1; hd <= 128."""
    dtype = q.dtype
    if dtype not in _SYMBOLS:
        raise ValueError(f"flash_attention: expected float32 or bfloat16, got {dtype}")
    cuda.check_cuda("flash_attention", q, k, v, dtypes=(dtype, dtype, dtype))
    if q.dim() != 3 or k.shape != v.shape or k.dim() != 3 or \
            k.shape[0] != q.shape[0] or k.shape[2] != q.shape[2]:
        raise ValueError(f"flash_attention: bad shapes q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    bh, s_len, hd = q.shape
    t_len = k.shape[1]
    if bh < 1 or s_len < 1 or t_len < 1 or bh > 65535:
        raise ValueError(f"flash_attention: need 1 <= BH <= 65535 and S, T >= 1, got "
                         f"BH {bh}, S {s_len}, T {t_len}")
    if not 1 <= hd <= MAX_HEAD_DIM:
        raise ValueError(f"flash_attention: head dim {hd} outside [1, {MAX_HEAD_DIM}]")
    out = torch.empty_like(q)
    cuda.launch("flash_attention", _SYMBOLS[dtype], _ARGS, cuda.ptr(q), cuda.ptr(k),
                cuda.ptr(v), cuda.ptr(out), bh, s_len, t_len, hd, int(bool(causal)),
                hd ** -0.5, cuda.stream(q.device))
    return out
