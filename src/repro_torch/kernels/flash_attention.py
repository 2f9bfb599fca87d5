"""Fused softmax attention, forward: the CUDA kernel
(``csrc/flash_attention.cu``) and its plain version
(:func:`repro_torch.kernels.ref.flash_attention_ref`).

Both take q (BH, S, hd) and k, v (BH, T, hd), all float32 or all bfloat16,
and return softmax(q k^T * hd^-1/2) v (BH, S, hd) in q's dtype, accumulated
in float32. ``causal`` keeps key position <= query position, top-left
aligned (also when S != T).

Under autograd the launch goes through :class:`FlashAttentionFunction`:
its forward is the one kernel launch, its backward the gradient of the
plain version recomputed from the saved q, k and v (the reference's flash
kernel has no VJP either: its training differentiates the einsum softmax).
No backward kernel is written.

The kernel reads rows of ``hd`` rounded up to 16 bytes (a multiple of 8
bfloat16 or 4 float32 elements) from 16-byte aligned bases: the bf16 path
loads its tiles by TMA, the f32 path by 16-byte ``cp.async``. Where an
input breaks that (hd = 20 in bf16, a view at an odd offset), the wrapper
makes one aligned copy, zero-padded past hd, before the single launch; zero
columns change no dot product. The output is written at its true hd.
:data:`aligned_copies` counts those copies.
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
#: inputs the wrapper copied to aligned, zero-padded rows since import
aligned_copies = 0

__all__ = ["FlashAttentionFunction", "flash_attention_cuda", "flash_attention_plain"]


def _row_width(hd: int, dtype: torch.dtype) -> int:
    """hd rounded up to 16 bytes: the row width the kernel reads."""
    per16 = 16 // dtype.itemsize
    return -(-hd // per16) * per16


def _aligned(x: torch.Tensor, ld: int) -> torch.Tensor:
    """x itself when its rows are ``ld`` wide and its base is 16-byte
    aligned; else one zero-padded copy that is."""
    global aligned_copies
    if x.shape[-1] == ld and x.data_ptr() % 16 == 0:
        return x
    aligned_copies += 1
    out = x.new_zeros((*x.shape[:-1], ld))
    out[..., :x.shape[-1]] = x
    return out


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
    ld = _row_width(hd, dtype)
    q, k, v = (_aligned(x, ld) for x in (q, k, v))
    out = torch.empty((bh, s_len, hd), dtype=dtype, device=q.device)
    cuda.launch("flash_attention", _SYMBOLS[dtype], _ARGS, cuda.ptr(q), cuda.ptr(k),
                cuda.ptr(v), cuda.ptr(out), bh, s_len, t_len, hd, int(bool(causal)),
                hd ** -0.5, cuda.stream(q.device))
    return out


class FlashAttentionFunction(torch.autograd.Function):
    """``apply(q, k, v, causal, launch)``: forward ``launch(q, k, v,
    causal)`` (the kernel, :func:`flash_attention_cuda`, whose output a
    ctypes launch writes outside the graph); backward the gradient of
    :func:`flash_attention_plain` at the saved inputs."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, launch):
        ctx.save_for_backward(q, k, v)
        ctx.causal = causal
        return launch(q, k, v, causal)

    @staticmethod
    def backward(ctx, grad_out):
        q, k, v = ctx.saved_tensors
        with torch.enable_grad():
            inputs = [t.detach().requires_grad_(True) for t in (q, k, v)]
            out = flash_attention_plain(*inputs, ctx.causal)
        grads = torch.autograd.grad(out, inputs, grad_out)
        return (*grads, None, None)
