"""GQA attention (mirrors ``repro.models.attention``): full (prefill and
forward), cross, and cached decode.

All shapes follow (B, S, H, head_dim). GQA shares each of the n_kv KV heads
among G = n_heads / n_kv query heads through a (B, S, Kv, G, hd) reshape;
query head h reads KV head h // G. Softmax accumulates in float32.

Attention over a whole sequence goes through :func:`self_attention`
(causal in the decoder, non-causal in whisper's encoder) or
:func:`cross_attention` (the decoder's queries over the encoder's T
frames, S != T). On the card each is one launch of the flash kernel
(:func:`repro_torch.kernels.ops.flash_attention`) over (B·H, S, hd)
queries and (B·H, T, hd) keys, with K and V expanded to the H query heads
by one copy (counted in :data:`kv_expansions`); the kernel keeps the scores
and the probabilities in float32 and never writes them out. The plain path, on the CPU or with
``impl="torch"``, computes what the reference computes at its rounding
points: the scores are a product in the compute dtype, cast to float32, and
the probabilities are cast back to the compute dtype before P·V.

Decode (a scalar or (B,) ``pos``, a per-row validity mask) is plain torch,
as in the reference. Where the reference returns updated caches, the port
writes the new key and value into the given caches in place and returns
them.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ops
from repro_torch.models.layers import apply_rope, dense, rope_angles

NEG_INF = -1e30
#: K/V expansions to the query heads made for the flash kernel since import
kv_expansions = 0


def qkv(p, x, xkv, n_heads: int, n_kv: int, head_dim: int):
    b, s = x.shape[:2]
    skv = xkv.shape[1]
    q = dense(p["wq"], x).reshape(b, s, n_heads, head_dim)
    k = dense(p["wk"], xkv).reshape(b, skv, n_kv, head_dim)
    v = dense(p["wv"], xkv).reshape(b, skv, n_kv, head_dim)
    return q, k, v


def gqa_scores(q, k):
    """q (B,S,H,hd), k (B,T,Kv,hd) -> scores (B,Kv,G,S,T) in q's dtype."""
    b, s, h, hd = q.shape
    kv = k.shape[2]
    qg = q.reshape(b, s, kv, h // kv, hd)
    return torch.einsum("bskgd,btkd->bkgst", qg, k) * (hd**-0.5)


def gqa_out(probs, v):
    """probs (B,Kv,G,S,T), v (B,T,Kv,hd) -> (B,S,H,hd)."""
    b, kv, g, s, t = probs.shape
    out = torch.einsum("bkgst,btkd->bskgd", probs, v)
    return out.reshape(b, s, kv * g, v.shape[-1])


def _masked_softmax_out(q, k, v, causal: bool, q_offset: int = 0):
    """The reference's plain attention body: scores in q's dtype, float32
    masked softmax, probabilities cast back, P·V. Query i sits at position
    ``q_offset + i``."""
    scores = gqa_scores(q, k).to(torch.float32)
    if causal:
        s, t = scores.shape[-2:]
        qpos = q_offset + torch.arange(s, device=q.device)
        mask = torch.arange(t, device=q.device)[None, :] <= qpos[:, None]
        scores = torch.where(mask, scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    return gqa_out(probs, v)


def _flash(q, k, v, causal: bool):
    """One flash kernel launch for (B,S,H,hd) q and (B,T,Kv,hd) k, v."""
    global kv_expansions
    b, s, h, hd = q.shape
    kv = k.shape[2]
    g = h // kv

    def heads(x):  # (B, S, Kv, hd) -> (B*H, S, hd), KV head h // G for head h
        x = x.permute(0, 2, 1, 3)
        if g > 1:
            x = x[:, :, None].expand(b, kv, g, x.shape[2], hd)
        return x.reshape(b * h, x.shape[-2], hd)

    if g > 1:
        kv_expansions += 1
    out = ops.flash_attention(q.permute(0, 2, 1, 3).reshape(b * h, s, hd),
                              heads(k), heads(v), causal=causal, impl="kernel")
    return out.reshape(b, h, s, hd).permute(0, 2, 1, 3)


def self_attention(q, k, v, *, causal: bool = True, q_chunk: int = 0,
                   impl: str = "auto"):
    """Attention of a sequence over itself: q (B,S,H,hd), k, v (B,S,Kv,hd)
    -> (B,S,H,hd). The flash kernel on the card (``impl`` as in
    :mod:`repro_torch.kernels.ops`); else the reference's plain body,
    query-chunked when ``q_chunk`` divides S."""
    if ops._use_kernel(impl, q):
        return _flash(q, k, v, causal)
    s = q.shape[1]
    if q_chunk and s % q_chunk == 0:
        return _chunked_attention(q, k, v, causal=causal, q_chunk=q_chunk)
    return _masked_softmax_out(q, k, v, causal)


def cross_attention(q, k, v, *, impl: str = "auto"):
    """Queries over another sequence, no mask: q (B,S,H,hd), k, v
    (B,T,Kv,hd) -> (B,S,H,hd). The flash kernel (non-causal) on the card,
    else the reference's plain body."""
    if ops._use_kernel(impl, q):
        return _flash(q, k, v, causal=False)
    return _masked_softmax_out(q, k, v, causal=False)


def full_attention(
    p,
    x,
    *,
    n_heads: int,
    n_kv: int,
    head_dim: int,
    causal: bool = True,
    use_rope: bool = True,
    rope_theta: float = 10000.0,
    xkv=None,
    positions=None,
    q_chunk: int = 0,
    impl: str = "auto",
):
    """Bidirectional/causal/cross attention over full sequences.

    q_chunk > 0 evaluates the plain self-attention path in query chunks:
    only (q_chunk, T) score tiles exist at a time (exact, not an
    approximation). On the card both self- and cross-attention go through
    the flash kernel instead, which tiles both axes itself."""
    self_attn = xkv is None
    if not self_attn and causal:
        raise ValueError("full_attention: cross-attention (xkv given) is never causal")
    xkv = x if xkv is None else xkv
    q, k, v = qkv(p, x, xkv, n_heads, n_kv, head_dim)
    if use_rope:
        pos = positions if positions is not None else torch.arange(x.shape[1], device=x.device)
        cos, sin = rope_angles(pos, head_dim, rope_theta)
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
    b, s = x.shape[:2]
    if self_attn:
        qc = q_chunk if s > q_chunk else 0
        out = self_attention(q, k, v, causal=causal, q_chunk=qc, impl=impl)
    else:
        out = cross_attention(q, k, v, impl=impl)
    return dense(p["wo"], out.reshape(b, s, -1))


def _chunked_attention(q, k, v, *, causal: bool, q_chunk: int):
    """Exact attention with the query axis processed in chunks (the
    reference's ``lax.scan`` as a loop)."""
    b, s, h, hd = q.shape
    outs = [_masked_softmax_out(q[:, lo:lo + q_chunk], k, v, causal, q_offset=lo)
            for lo in range(0, s, q_chunk)]
    return torch.cat(outs, dim=1)


def decode_attention(
    p,
    x_new,
    cache_k,
    cache_v,
    pos,
    *,
    n_heads: int,
    n_kv: int,
    head_dim: int,
    use_rope: bool = True,
    rope_theta: float = 10000.0,
):
    """One-token decode. x_new (B,1,D); cache_k/v (B,S,Kv,hd); pos an int,
    a 0-d tensor or (B,) per-sequence positions (tokens already in cache).
    Writes the new key and value at pos into the caches in place and
    returns (out (B,1,D), cache_k, cache_v)."""
    b = x_new.shape[0]
    dev = x_new.device
    pos_b = torch.as_tensor(pos, dtype=torch.long, device=dev).expand(b)
    q, k, v = qkv(p, x_new, x_new, n_heads, n_kv, head_dim)
    if use_rope:
        cos, sin = rope_angles(pos_b[:, None], head_dim, rope_theta)  # (B,1,hd/2)
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
    rows = torch.arange(b, device=dev)
    cache_k[rows, pos_b] = k[:, 0].to(cache_k.dtype)
    cache_v[rows, pos_b] = v[:, 0].to(cache_v.dtype)
    scores = gqa_scores(q, cache_k).to(torch.float32)  # (B,Kv,G,1,S)
    smax = cache_k.shape[1]
    valid = (torch.arange(smax, device=dev)[None, None, None, None, :]
             <= pos_b[:, None, None, None, None])
    scores = torch.where(valid, scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(x_new.dtype)
    out = gqa_out(probs, cache_v)
    return dense(p["wo"], out.reshape(b, 1, -1)), cache_k, cache_v
