"""Shared neural layers (mirrors ``repro.models.layers``): pure functions
over trees of tensors.

Conventions, as in the reference: compute runs in ``cfg.compute_dtype``;
parameters are stored in ``cfg.param_dtype`` and cast to the compute dtype
at each product. Norms accumulate in float32. The parameters' shapes and
initial draws are laid out in :func:`repro_torch.models.model.param_layout`.
"""
from __future__ import annotations

import math

import torch


def dense(p, x: torch.Tensor) -> torch.Tensor:
    y = x @ p["w"].to(x.dtype)
    if "b" in p:
        y = y + p["b"].to(x.dtype)
    return y


def embed(p, ids: torch.Tensor) -> torch.Tensor:
    return p["table"][ids]


def apply_norm(p, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    xf = x.to(torch.float32)
    if "bias" in p:  # layernorm
        mu = torch.mean(xf, dim=-1, keepdim=True)
        var = torch.mean(torch.square(xf - mu), dim=-1, keepdim=True)
        y = (xf - mu) * torch.rsqrt(var + eps)
        y = y * p["scale"].to(torch.float32) + p["bias"].to(torch.float32)
    else:  # rmsnorm
        ms = torch.mean(xf * xf, dim=-1, keepdim=True)
        y = xf * torch.rsqrt(ms + eps) * p["scale"].to(torch.float32)
    return y.to(x.dtype)


def silu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.silu`` as it is written, x * (1 / (1 + exp(-x))), each step
    rounded to x's dtype (so bf16 results match the reference's)."""
    return x * (1 / (1 + torch.exp(-x)))


def gelu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu`` (the tanh approximation, its default) as it is
    written, constants and each step in x's dtype."""
    def c(v):
        return torch.tensor(v, dtype=x.dtype, device=x.device)

    cdf = c(0.5) * (c(1.0) + torch.tanh(c(math.sqrt(2 / math.pi))
                                        * (x + c(0.044715) * (x * x * x))))
    return x * cdf


def mlp(p, x: torch.Tensor) -> torch.Tensor:
    if "gate" in p:
        h = silu(dense(p["gate"], x)) * dense(p["up"], x)
        return dense(p["down"], h)
    return dense(p["proj"], gelu(dense(p["fc"], x)))


def rope_angles(positions: torch.Tensor, head_dim: int, theta: float):
    """positions (...,) -> (cos, sin) each (..., head_dim//2) in float32."""
    half = head_dim // 2
    exps = -torch.arange(0, half, dtype=torch.float32, device=positions.device) / half
    freqs = torch.pow(torch.tensor(theta, dtype=torch.float32, device=positions.device), exps)
    ang = positions.to(torch.float32)[..., None] * freqs
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x (..., S, H, hd); cos/sin (..., S, hd//2) broadcast over heads."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    c = cos[..., None, :].to(x.dtype)
    s = sin[..., None, :].to(x.dtype)
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)
