"""Attention-free sequence mixers (mirrors ``repro.models.ssm``): RWKV6
(Finch) and Mamba (for Jamba).

Both have two modes:
  * ``*_seq``  — a whole sequence (training / prefill),
  * ``*_step`` — one token with explicit state (decode).
The decode state is O(1) in sequence length; it stays in float32 where the
reference keeps it so (the WKV state, Mamba's h).

The reference's ``lax.scan`` over time is a Python loop over the time steps
here. Where the reference computes a step's token-wise products inside its
scan body (RWKV6's projections, Mamba's none), the port computes them for
the whole sequence before the loop: they read no state, so each row is the
same function of its token, and the loop carries only the recurrence. The
chunked WKV (``rwkv6_time_mix_seq_chunked``) loops over chunks.
"""
from __future__ import annotations

import torch

from repro_torch.mesh import scan
from repro_torch.models.layers import apply_norm, dense, silu


def _shift(x: torch.Tensor) -> torch.Tensor:
    """x (B, S, D) shifted one step later along S, zeros first (the
    reference's ``jnp.pad(x, ((0,0),(1,0),(0,0)))[:, :-1]``)."""
    return torch.nn.functional.pad(x, (0, 0, 1, 0))[:, :-1]


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: log(1 + e^x) as ``logaddexp(x, 0)`` (no
    threshold, unlike ``torch.nn.functional.softplus``)."""
    return torch.logaddexp(x, torch.zeros_like(x))


# =============================================================== RWKV6 ===
def _rwkv6_rklg(p, x, x_prev):
    """Token-shift mixes + projections. x, x_prev (..., D) -> r, k, v, the
    log-decay log w (float32, <= 0) and g."""
    def mix(i):
        return x + (x_prev - x) * p["mu"][i].to(x.dtype)

    r = dense(p["wr"], mix(0))
    k = dense(p["wk"], mix(1))
    v = dense(p["wv"], mix(2))
    xw = mix(3)
    g = dense(p["wg"], mix(4))
    # data-dependent decay (Finch): w = exp(-exp(w0 + lora(xw)))
    dd = torch.tanh(xw @ p["w_lora_a"].to(x.dtype)) @ p["w_lora_b"].to(x.dtype)
    return r, k, v, -torch.exp(p["w0"].to(torch.float32) + dd.to(torch.float32)), g


def _rwkv6_rkvwg(p, x, x_prev):
    """:func:`_rwkv6_rklg` with the decay w itself."""
    r, k, v, lw, g = _rwkv6_rklg(p, x, x_prev)
    return r, k, v, torch.exp(lw), g


def _rwkv6_core(r, k, v, w, u, state):
    """One recurrence step per head. r,k,v,w (B,H,hd); state (B,H,hd,hd).
    y = r @ (state + u * k^T v); state' = diag(w) state + k^T v."""
    kv = k[..., :, None] * v[..., None, :]  # (B,H,hd,hd)
    y = torch.einsum("bhi,bhij->bhj", r, state + u[None, :, :, None] * kv)
    new_state = w[..., :, None] * state + kv
    return y, new_state


def wkv_sequential(r, k, v, w, u, head_dim: int):
    """The WKV recurrence one step at a time over heads of ``head_dim``: r,
    k, v (B, S, H·hd), the decay w (B, S, H·hd) float32, the bonus u (H,
    hd). Returns (y (B, S, H·hd) float32, the final state (B, H, hd, hd)
    float32)."""
    b, s, d = r.shape
    h = d // head_dim
    rh = r.reshape(b, s, h, head_dim).to(torch.float32)
    kh = k.reshape(b, s, h, head_dim).to(torch.float32)
    vh = v.reshape(b, s, h, head_dim).to(torch.float32)
    wh = w.reshape(b, s, h, head_dim)
    u = u.to(torch.float32)
    state = torch.zeros((b, h, head_dim, head_dim), dtype=torch.float32, device=r.device)
    ys = []
    for t in range(s):
        y, state = _rwkv6_core(rh[:, t], kh[:, t], vh[:, t], wh[:, t], u, state)
        ys.append(y)
    return torch.stack(ys, dim=1).reshape(b, s, d), state


def rwkv6_time_mix_seq(p, x: torch.Tensor, head_dim: int, return_state: bool = False):
    """x (B, S, D) -> (B, S, D), the recurrence one step at a time. With
    return_state, also returns the decode state (x_prev (B,D), wkv
    (B,H,hd,hd) float32)."""
    r, k, v, w, g = _rwkv6_rkvwg(p, x, _shift(x))
    y, state = wkv_sequential(r, k, v, w, p["u"], head_dim)
    out = dense(p["wo"], apply_norm(p["ln_x"], y.to(x.dtype)) * silu(g))
    if return_state:
        return out, (x[:, -1], state)
    return out


def rwkv6_time_mix_step(p, xt: torch.Tensor, state, head_dim: int):
    """Decode step. xt (B, D); state = (x_prev (B,D), wkv (B,H,hd,hd))."""
    x_prev, wkv = state
    b, d = xt.shape
    h = d // head_dim
    r, k, v, w, g = _rwkv6_rkvwg(p, xt, x_prev)
    y, wkv = _rwkv6_core(
        r.reshape(b, h, head_dim).to(torch.float32),
        k.reshape(b, h, head_dim).to(torch.float32),
        v.reshape(b, h, head_dim).to(torch.float32),
        w.reshape(b, h, head_dim),
        p["u"].to(torch.float32),
        wkv,
    )
    y = apply_norm(p["ln_x"], y.reshape(b, d).to(xt.dtype)) * silu(g)
    return dense(p["wo"], y), (xt, wkv)


def rwkv6_channel_mix(p, x: torch.Tensor, x_prev: torch.Tensor):
    """x, x_prev (B, [S,] D)."""
    xk = x + (x_prev - x) * p["mu"][0].to(x.dtype)
    xr = x + (x_prev - x) * p["mu"][1].to(x.dtype)
    k = torch.square(torch.relu(dense(p["wk"], xk)))
    return torch.sigmoid(dense(p["wr"], xr)) * dense(p["wv"], k)


def rwkv6_time_mix_seq_chunked(p, x: torch.Tensor, head_dim: int, chunk: int = 64,
                               return_state: bool = False):
    """Chunked (flash-linear-attention style) WKV, equal to
    :func:`rwkv6_time_mix_seq` within its validity bound: the projections
    over the whole sequence at once; inside a chunk the interactions are a
    masked (C, C) product of decay-weighted r and k; across chunks they flow
    through the (hd, hd) state, S / C loop trips.

    Decay ratios exp(cum_{t-1} - cum_tau) <= 1 are computed by the bounded
    two-factor split, the k-side exponent clamped at +30. VALIDITY BOUND:
    exact while a chunk's cumulative log-decay stays within the clamp
    (chunk * |log w| <= 30 a channel: w >= 0.63 a step at chunk 64, 0.39 at
    32); faster-forgetting channels have their (e^-30-scale) tails
    approximated. The sequential path (``rwkv_chunk = 0``) is exact in every
    regime."""
    r, k, v, lw, g = _rwkv6_rklg(p, x, _shift(x))
    y, state = wkv_chunked(r, k, v, lw, p["u"], head_dim, chunk)
    out = dense(p["wo"], apply_norm(p["ln_x"], y.to(x.dtype)) * silu(g))
    if return_state:
        return out, (x[:, -1], state)
    return out


def wkv_chunked(r, k, v, lw, u, head_dim: int, chunk: int):
    """The chunked WKV of :func:`rwkv6_time_mix_seq_chunked` over heads of
    ``head_dim``: r, k, v (B, S, H·hd), the log-decay lw (B, S, H·hd)
    float32, the bonus u (H, hd). Returns (y (B, S, H·hd) float32, the
    final state (B, H, hd, hd) float32)."""
    b, s, d = r.shape
    h = d // head_dim
    assert s % chunk == 0, (s, chunk)
    nc = s // chunk

    def heads(t):  # (B, S, D) -> (B, nc, C, H, hd)
        return t.reshape(b, nc, chunk, h, head_dim)

    rh = heads(r).to(torch.float32)
    kh = heads(k).to(torch.float32)
    vh = heads(v).to(torch.float32)
    lwh = heads(lw)
    u = u.to(torch.float32)  # (H, hd)

    cum = torch.cumsum(lwh, dim=2)  # inclusive per-chunk cumulative log-decay
    cum_prev = cum - lwh  # cum_{t-1} (0 at chunk start)
    r_t = rh * torch.exp(cum_prev)  # bounded <= |r|
    k_t = kh * torch.exp(torch.clamp_max(-cum, 30.0))  # bounded two-factor split
    k_end = kh * torch.exp(cum[:, :, -1:] - cum)  # decay to chunk end <= |k|

    # intra-chunk: scores[t, tau] = sum_i r[t,i] k[tau,i] exp(cum[t-1]-cum[tau])
    scores = torch.einsum("bnthi,bnchi->bnhtc", r_t, k_t)
    tri = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool, device=r.device), -1)
    scores = torch.where(tri, scores, 0.0)
    diag = torch.einsum("bnthi,hi,bnthi->bnth", rh, u, kh)  # bonus term
    y = torch.einsum("bnhtc,bnchj->bnthj", scores, vh) + diag[..., None] * vh

    # cross-chunk: the (B, H, hd_k, hd_v) state, one chunk at a time
    decay_chunk = torch.exp(cum[:, :, -1])  # (B, nc, H, hd)
    kv_chunk = torch.einsum("bnthi,bnthj->bnhij", k_end, vh)
    state = torch.zeros((b, h, head_dim, head_dim), dtype=torch.float32, device=r.device)
    y_cross = []
    for n in range(nc):
        y_cross.append(torch.einsum("bthi,bhij->bthj", r_t[:, n], state))
        state = decay_chunk[:, n, ..., None] * state + kv_chunk[:, n]
    y = y + torch.stack(y_cross, dim=1)  # (B, nc, C, H, hd)
    return y.reshape(b, s, d), state


# ================================================================ Mamba ===
def _mamba_ssm_params(p, x, dt_rank: int, d_state: int):
    """x (..., din) -> (dt (...,din), B (...,N), C (...,N)), float32."""
    return ssm_split(dense(p["x_proj"], x), p["dt_proj"], dt_rank, d_state)


def ssm_split(proj, dt_proj, dt_rank: int, d_state: int):
    """x_proj's output (..., dt_rank + 2N) -> (dt (..., C) through
    ``dt_proj``'s C columns, B (..., N), C (..., N)), float32."""
    b_mat = proj[..., dt_rank: dt_rank + d_state].to(torch.float32)
    c_mat = proj[..., dt_rank + d_state:].to(torch.float32)
    dt = softplus(dense(dt_proj, proj[..., :dt_rank]).to(torch.float32))
    return dt, b_mat, c_mat


def _mamba_step_core(p, xt, dt, b_mat, c_mat, h):
    """Selective-scan step: xt/dt (B,din), b/c (B,N), h (B,din,N)."""
    a = -torch.exp(p["a_log"].to(torch.float32))  # (din, N)
    da = torch.exp(dt[..., None] * a[None])  # (B,din,N)
    h = da * h + (dt * xt.to(torch.float32))[..., None] * b_mat[:, None, :]
    y = torch.einsum("bdn,bn->bd", h, c_mat) + p["d"].to(torch.float32) * xt.to(torch.float32)
    return y, h


def mamba_seq(p, x: torch.Tensor, *, d_state: int = 16, d_conv: int = 4,
              expand: int = 2, dt_rank: int | None = None, return_state: bool = False):
    """x (B, S, D) -> (B, S, D). Causal depthwise conv + the sequential
    selective scan (:func:`repro_torch.mesh.scan`, a plain loop unless a
    dry run's counter represents its steps). With return_state, also
    returns (conv_buf (B, d_conv-1, din), h (B, din, N) float32)."""
    b, s, d = x.shape
    din = expand * d
    dt_rank = dt_rank or max(1, d // 16)
    xz = dense(p["in_proj"], x)
    xi, xpad = causal_conv(xz[..., :din], p["conv_w"], p["conv_b"], d_conv)
    dt, b_mat, c_mat = _mamba_ssm_params(p, xi, dt_rank, d_state)
    y, h = selective_scan(xi, dt, b_mat, c_mat, p["a_log"], p["d"])
    out = dense(p["out_proj"], y.to(x.dtype) * silu(xz[..., din:]))
    if return_state:
        return out, (xpad[:, s:s + d_conv - 1], h)  # the last d_conv-1 raw inputs
    return out


def causal_conv(xraw, conv_w, conv_b, d_conv: int):
    """Mamba's causal depthwise conv over time of xraw (B, S, C) (conv_w (d_conv,
    C), conv_b (C)), summed in the reference's order, and its silu: (xi,
    xraw padded with d_conv - 1 zeros in front)."""
    s = xraw.shape[1]
    xpad = torch.nn.functional.pad(xraw, (0, 0, d_conv - 1, 0))
    conv = 0
    for i in range(d_conv):
        conv = conv + xpad[:, i:i + s] * conv_w[i].to(xraw.dtype)
    return silu(conv + conv_b.to(xraw.dtype)), xpad


def conv_step(window, conv_w, conv_b, dtype):
    """The causal conv's one new output over the window (B, d_conv, C) of
    the last d_conv raw inputs, in float32, and its silu cast to ``dtype``:
    (B, C)."""
    conv = torch.einsum("bcd,cd->bd", window.to(torch.float32), conv_w.to(torch.float32))
    return silu(conv + conv_b.to(torch.float32)).to(dtype)


def selective_scan(xi, dt, b_mat, c_mat, a_log, d):
    """The sequential selective scan (:func:`repro_torch.mesh.scan`, a plain
    loop unless a dry run's counter represents its steps) over xi, dt (B,
    S, C) and b_mat, c_mat (B, S, N), with a_log (C, N) and d (C): (y (B,
    S, C) float32, the final h (B, C, N) float32)."""
    b, _, c = xi.shape
    h = torch.zeros((b, c, b_mat.shape[-1]), dtype=torch.float32, device=xi.device)
    ys, h = scan(lambda xt, dtt, bt, ct, hh, a, dd: _mamba_step_core(
        {"a_log": a, "d": dd}, xt, dtt, bt, ct, hh), xi.shape[1], h, (xi, dt, b_mat, c_mat),
        (a_log, d))
    return torch.stack(ys, dim=1), h


def mamba_step(p, xt: torch.Tensor, state, *, d_state: int = 16, d_conv: int = 4,
               expand: int = 2, dt_rank: int | None = None):
    """Decode step. xt (B, D); state = (conv_buf (B, d_conv-1, din), h
    (B,din,N))."""
    conv_buf, h = state
    b, d = xt.shape
    din = expand * d
    dt_rank = dt_rank or max(1, d // 16)
    xz = dense(p["in_proj"], xt)
    xi, z = xz[..., :din], xz[..., din:]
    window = torch.cat([conv_buf, xi[:, None, :]], dim=1)  # (B, d_conv, din)
    xc = conv_step(window, p["conv_w"], p["conv_b"], xt.dtype)
    dt, b_mat, c_mat = _mamba_ssm_params(p, xc, dt_rank, d_state)
    y, h = _mamba_step_core(p, xc, dt, b_mat, c_mat, h)
    y = y.to(xt.dtype) * silu(z)
    return dense(p["out_proj"], y), (window[:, 1:], h)
