"""Model assembly (mirrors ``repro.models.model``): ArchConfig -> params /
forward / prefill / decode.

Layers are organised into *groups*, the smallest repeating layer pattern,
and each in-group position's parameters are stacked over groups, as in the
reference; its ``lax.scan`` over the stack is a Python loop over the groups
here. Parameters are a plain tree of tensors (nested dicts, the reference's
keys and shapes), so :func:`repro_torch.models.convert.params_from_arrays`
maps the reference's weights one to one.

Decode carries a per-group cache tree through the same loop. Attention
decode dispatches on ``cfg.attention_kind``:
  'full' — dense cached attention,
  'taco' — TaCo retrieval attention
           (:mod:`repro_torch.models.taco_attention`), the paper's technique.

This slice runs the dense family only: ``mixer="attn"``, no experts, no
encoder, no frontend. Any other config raises ``NotImplementedError``.
Causal self-attention in ``forward`` and ``prefill`` goes through the flash
kernel on the card (``impl``, as in :mod:`repro_torch.kernels.ops`); see
:mod:`repro_torch.models.attention`. ``decode_step`` and ``prefill`` write
the caches in place (the reference returns new ones).
"""
from __future__ import annotations

import dataclasses

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.models import attention as A
from repro_torch.models import taco_attention as TA
from repro_torch.models.layers import apply_norm, apply_rope, dense, embed, mlp, rope_angles
from repro_torch.utils import resolve_device, tree_flatten


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0  # 0 -> d_model // n_heads
    norm: str = "rmsnorm"  # rmsnorm | layernorm
    mlp: str = "swiglu"  # swiglu | gelu
    qkv_bias: bool = False
    use_rope: bool = True
    rope_theta: float = 10000.0
    norm_eps: float = 1e-5
    # --- MoE
    n_experts: int = 0
    experts_per_token: int = 0
    moe_every: int = 1  # MoE FFN on layers where (i % moe_every == moe_every-1)
    moe_dense_residual: bool = False  # arctic: dense MLP in parallel with MoE
    dense_d_ff: int = 0
    capacity_factor: float = 1.25
    # --- mixer pattern
    mixer: str = "attn"  # attn | rwkv | hybrid (mamba+attn)
    attn_every: int = 1  # hybrid: attention on layers where (i % attn_every == attn_pos)
    attn_pos: int = 0
    # --- mamba / rwkv
    mamba_d_state: int = 16
    mamba_d_conv: int = 4
    mamba_expand: int = 2
    rwkv_head_dim: int = 64
    rwkv_chunk: int = 64  # chunked WKV (0 = sequential scan)
    # --- enc-dec / frontends
    encoder_layers: int = 0
    frontend: str | None = None  # audio | vlm
    frontend_len: int = 0  # encoder frames / image patches
    # --- execution
    attention_kind: str = "full"  # full | taco
    attn_q_chunk: int = 0  # 0 = auto (2048 when seq >= 8192); flash-lite tiling
    max_positions: int = 32768  # learned-position table length (non-RoPE archs)
    retrieval: TA.RetrievalConfig = dataclasses.field(default_factory=TA.RetrievalConfig)
    compute_dtype: str = "bfloat16"
    param_dtype: str = "float32"
    #: recompute each layer group in the backward pass (torch.utils.checkpoint)
    remat: bool = True

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def padded_vocab(self) -> int:
        """Vocab rounded to a multiple of 256 (the reference's Megatron-style
        padding); forward slices logits back to the true vocab."""
        v = self.vocab_size
        return v if v % 256 == 0 else (v + 255) // 256 * 256

    @property
    def cdtype(self) -> torch.dtype:
        return getattr(torch, self.compute_dtype)

    @property
    def pdtype(self) -> torch.dtype:
        return getattr(torch, self.param_dtype)

    @property
    def group_size(self) -> int:
        g = 1
        if self.mixer == "hybrid":
            g = self.attn_every
        if self.n_experts and self.moe_every > 1:
            g = _lcm(g, self.moe_every)
        return g

    @property
    def n_groups(self) -> int:
        assert self.n_layers % self.group_size == 0, (self.n_layers, self.group_size)
        return self.n_layers // self.group_size

    def layer_specs(self) -> list[dict]:
        """Per-group sub-layer pattern."""
        specs = []
        for i in range(self.group_size):
            if self.mixer == "attn":
                mixer = "attn"
            elif self.mixer == "rwkv":
                mixer = "rwkv"
            elif self.mixer == "hybrid":
                mixer = "attn" if (i % self.attn_every == self.attn_pos) else "mamba"
            else:
                raise ValueError(self.mixer)
            if self.n_experts and (i % self.moe_every == self.moe_every - 1):
                ffn = "moe_dense" if self.moe_dense_residual else "moe"
            elif mixer == "rwkv":
                ffn = "channel_mix"
            else:
                ffn = "mlp"
            specs.append({"mixer": mixer, "ffn": ffn})
        return specs


def _lcm(a, b):
    import math

    return a * b // math.gcd(a, b)


def check_ported(cfg: ArchConfig) -> None:
    """Raise for a config outside the dense family this slice ports."""
    unported = [what for what, present in (
        (f"{cfg.n_experts} experts", cfg.n_experts),
        (f"mixer={cfg.mixer!r}", cfg.mixer != "attn"),
        (f"{cfg.encoder_layers} encoder layers", cfg.encoder_layers),
        (f"frontend={cfg.frontend!r}", cfg.frontend is not None),
    ) if present]
    if unported:
        raise NotImplementedError(
            f"{cfg.name}: {', '.join(unported)}: the port runs the dense family "
            "(attention mixer, MLP, no encoder or frontend); the moe, ssm, hybrid, "
            "audio and vlm branches come in a later slice")


# ============================================================ layout ======
@dataclasses.dataclass(frozen=True)
class Leaf:
    """One parameter's shape and initial draw: ``normal`` (times
    ``scale``), ``ones`` or ``zeros``."""

    shape: tuple
    init: str
    scale: float = 1.0


def _dense_layout(d_in: int, d_out: int, bias: bool, lead: tuple = ()):
    p = {"w": Leaf((*lead, d_in, d_out), "normal", d_in**-0.5)}
    if bias:
        p["b"] = Leaf((*lead, d_out), "zeros")
    return p


def _norm_layout(cfg: ArchConfig, lead: tuple = ()):
    p = {"scale": Leaf((*lead, cfg.d_model), "ones")}
    if cfg.norm == "layernorm":
        p["bias"] = Leaf((*lead, cfg.d_model), "zeros")
    return p


def _sublayer_layout(cfg: ArchConfig, lead: tuple):
    d, hd, bias = cfg.d_model, cfg.hd, cfg.qkv_bias
    attn = {
        "wq": _dense_layout(d, cfg.n_heads * hd, bias, lead),
        "wk": _dense_layout(d, cfg.n_kv_heads * hd, bias, lead),
        "wv": _dense_layout(d, cfg.n_kv_heads * hd, bias, lead),
        "wo": _dense_layout(cfg.n_heads * hd, d, bias, lead),
    }
    if cfg.mlp == "swiglu":
        ffn = {"gate": _dense_layout(d, cfg.d_ff, bias, lead),
               "up": _dense_layout(d, cfg.d_ff, bias, lead),
               "down": _dense_layout(cfg.d_ff, d, bias, lead)}
    elif cfg.mlp == "gelu":
        ffn = {"fc": _dense_layout(d, cfg.d_ff, bias, lead),
               "proj": _dense_layout(cfg.d_ff, d, bias, lead)}
    else:
        raise ValueError(cfg.mlp)
    return {"ln1": _norm_layout(cfg, lead), "attn": attn,
            "ln2": _norm_layout(cfg, lead), "ffn": ffn}


def param_layout(cfg: ArchConfig) -> dict:
    """The parameter tree as :class:`Leaf` s: the reference's keys, with the
    blocks' leaves stacked over ``n_groups``."""
    check_ported(cfg)
    lead = (cfg.n_groups,)
    return {
        "embed": {"table": Leaf((cfg.padded_vocab, cfg.d_model), "normal", cfg.d_model**-0.5)},
        "final_norm": _norm_layout(cfg),
        "lm_head": _dense_layout(cfg.d_model, cfg.padded_vocab, False),
        "blocks": {f"l{i}": _sublayer_layout(cfg, lead)
                   for i, _spec in enumerate(cfg.layer_specs())},
    }


def map_tree(fn, tree):
    """``fn`` over the leaves of a tree of dicts and :class:`RetrievalState` s."""
    if isinstance(tree, dict):
        return {k: map_tree(fn, v) for k, v in tree.items()}
    if isinstance(tree, TA.RetrievalState):
        return TA.RetrievalState(**{f.name: fn(getattr(tree, f.name))
                                    for f in dataclasses.fields(tree)})
    return fn(tree)


def tree_leaves(tree) -> list:
    out = []
    map_tree(out.append, tree)
    return out


# ============================================================== init ======
def init_params(generator: torch.Generator, cfg: ArchConfig,
                device: str | torch.device = "cuda") -> dict:
    """Seeded parameters on ``device``: fan-in scaled normals for products
    and embeddings, ones and zeros for norms and biases, in
    ``cfg.param_dtype``. Draws run on the generator's device."""
    dev = resolve_device(device)

    def draw(leaf: Leaf) -> torch.Tensor:
        if leaf.init == "normal":
            x = torch.randn(leaf.shape, generator=generator, device=generator.device,
                            dtype=torch.float32) * leaf.scale
        else:
            x = (torch.ones if leaf.init == "ones" else torch.zeros)(leaf.shape)
        return x.to(device=dev, dtype=cfg.pdtype)

    return map_tree(draw, param_layout(cfg))


def param_count(params) -> int:
    return int(sum(x.numel() for x in tree_leaves(params)))


def _at(tree, g: int):
    """Group ``g`` of a stacked tree (views: writes reach the stack)."""
    return map_tree(lambda t: t[g], tree)


def _groups(tree, n: int) -> list:
    """The ``n`` groups of a stacked tree of parameters, as views from one
    ``torch.unbind`` a leaf: in a backward pass autograd then stacks the
    groups' gradients once, where one ``t[g]`` a group would add a
    zero-filled tensor of the whole stack for each."""
    leaves, rebuild = tree_flatten(tree)
    parts = [torch.unbind(t, 0) for t in leaves]
    return [rebuild([p[g] for p in parts]) for g in range(n)]


# ============================================================ forward =====
def _apply_sublayer_seq(cfg: ArchConfig, p, x, impl: str):
    h = apply_norm(p["ln1"], x, cfg.norm_eps)
    qc = cfg.attn_q_chunk or (2048 if x.shape[1] >= 8192 else 0)
    x = x + A.full_attention(
        p["attn"], h, n_heads=cfg.n_heads, n_kv=cfg.n_kv_heads, head_dim=cfg.hd,
        causal=True, use_rope=cfg.use_rope, rope_theta=cfg.rope_theta,
        q_chunk=qc, impl=impl,
    )
    h = apply_norm(p["ln2"], x, cfg.norm_eps)
    return x + mlp(p["ffn"], h)


def _apply_group_seq(cfg: ArchConfig, group_p, x, impl: str):
    for i, _spec in enumerate(cfg.layer_specs()):
        x = _apply_sublayer_seq(cfg, group_p[f"l{i}"], x, impl)
    return x


def forward(params, cfg: ArchConfig, batch: dict, *, impl: str = "auto"):
    """Training/prefill forward. batch: {'tokens': (B, S)}. Returns (logits
    (B, S, V) float32, aux 0.0). With ``cfg.remat``, where a parameter
    requires a gradient, each layer group is recomputed in the backward
    pass (non-reentrant ``torch.utils.checkpoint``, as ``jax.checkpoint``
    wraps the reference's scan body)."""
    check_ported(cfg)
    remat = cfg.remat and torch.is_grad_enabled() and any(
        t.requires_grad for t in tree_flatten(params)[0])
    x = embed(params["embed"], batch["tokens"]).to(cfg.cdtype)
    for group_p in _groups(params["blocks"], cfg.n_groups):
        if remat:
            x = checkpoint(_apply_group_seq, cfg, group_p, x, impl, use_reentrant=False)
        else:
            x = _apply_group_seq(cfg, group_p, x, impl)
    x = apply_norm(params["final_norm"], x, cfg.norm_eps)
    logits = dense(params["lm_head"], x)[..., : cfg.vocab_size]
    return logits.to(torch.float32), torch.zeros((), dtype=torch.float32, device=x.device)


# ============================================================= decode =====
def init_cache(cfg: ArchConfig, batch_size: int, max_seq: int, *, taco=False,
               device: str | torch.device = "cuda") -> dict:
    """Zero-initialised per-group decode cache tree on ``device``."""
    check_ported(cfg)
    dev = resolve_device(device)
    g = cfg.n_groups
    kv, hd = cfg.n_kv_heads, cfg.hd

    def zeros(shape, dtype=cfg.cdtype):
        return torch.zeros(shape, dtype=dtype, device=dev)

    cache: dict = {}
    for i, _spec in enumerate(cfg.layer_specs()):
        c = {"k": zeros((g, batch_size, max_seq, kv, hd)),
             "v": zeros((g, batch_size, max_seq, kv, hd))}
        if taco or cfg.attention_kind == "taco":
            rc = cfg.retrieval
            ns, sk = rc.n_subspaces, rc.sqrt_k
            c["taco"] = TA.RetrievalState(
                mean=zeros((g, kv, hd), torch.float32),
                basis=zeros((g, kv, hd, rc.m), torch.float32),
                centroids=zeros((g, kv, ns, 2, sk, rc.subspace_dim // 2), torch.float32),
                cells=zeros((g, batch_size, kv, ns, max_seq), torch.int32),
                cell_sizes=zeros((g, batch_size, kv, ns, sk, sk), torch.int32),
            )
        cache[f"l{i}"] = c
    return cache


def _apply_sublayer_step(cfg: ArchConfig, p, c, x, pos):
    """One-token step. x (B,1,D); c = this sub-layer's cache for one group,
    updated in place. Returns x."""
    h = apply_norm(p["ln1"], x, cfg.norm_eps)
    if cfg.attention_kind == "taco" and "taco" in c:
        out, _k, _v, _st = TA.taco_decode_attention(
            p["attn"], h, c["k"], c["v"], c["taco"], pos, cfg.retrieval,
            n_heads=cfg.n_heads, n_kv=cfg.n_kv_heads, head_dim=cfg.hd,
            use_rope=cfg.use_rope, rope_theta=cfg.rope_theta,
        )
    else:
        out, _k, _v = A.decode_attention(
            p["attn"], h, c["k"], c["v"], pos,
            n_heads=cfg.n_heads, n_kv=cfg.n_kv_heads, head_dim=cfg.hd,
            use_rope=cfg.use_rope, rope_theta=cfg.rope_theta,
        )
    x = x + out
    h = apply_norm(p["ln2"], x, cfg.norm_eps)
    return x + mlp(p["ffn"], h)


def decode_step(params, cfg: ArchConfig, cache: dict, tokens: torch.Tensor, pos):
    """Logits for one new token. tokens (B, 1); pos = number of cached
    tokens (an int, or a (B,) tensor per sequence for batched serving).
    Returns (logits (B,1,V) float32, cache), the cache updated in place."""
    check_ported(cfg)
    x = embed(params["embed"], tokens).to(cfg.cdtype)
    for g in range(cfg.n_groups):
        group_p, group_c = _at(params["blocks"], g), _at(cache, g)
        for i, _spec in enumerate(cfg.layer_specs()):
            x = _apply_sublayer_step(cfg, group_p[f"l{i}"], group_c[f"l{i}"], x, pos)
    x = apply_norm(params["final_norm"], x, cfg.norm_eps)
    logits = dense(params["lm_head"], x)[..., : cfg.vocab_size]
    return logits.to(torch.float32), cache


# ============================================================= prefill ====
def prefill(params, cfg: ArchConfig, batch: dict, max_seq: int, *, impl: str = "auto"):
    """Run the full prompt, returning (last logits (B,1,V), populated cache).
    For attention_kind == 'taco', the TaCo retrieval index over the cached
    keys is built here."""
    check_ported(cfg)
    tokens = batch["tokens"]
    b, s = tokens.shape
    x = embed(params["embed"], tokens).to(cfg.cdtype)
    cache = init_cache(cfg, b, max_seq, taco=cfg.attention_kind == "taco", device=x.device)
    qc = cfg.attn_q_chunk or (2048 if s >= 8192 else 0)
    if cfg.use_rope:
        cos, sin = rope_angles(torch.arange(s, device=x.device), cfg.hd, cfg.rope_theta)
    for g in range(cfg.n_groups):
        group_p, group_c = _at(params["blocks"], g), _at(cache, g)
        for i, _spec in enumerate(cfg.layer_specs()):
            p, c = group_p[f"l{i}"], group_c[f"l{i}"]
            h = apply_norm(p["ln1"], x, cfg.norm_eps)
            q, k, v = A.qkv(p["attn"], h, h, cfg.n_heads, cfg.n_kv_heads, cfg.hd)
            if cfg.use_rope:
                q = apply_rope(q, cos, sin)
                k = apply_rope(k, cos, sin)
            out = A.self_attention(q, k, v, causal=True, q_chunk=qc, impl=impl)
            x = x + dense(p["attn"]["wo"], out.reshape(b, s, -1))
            c["k"][:, :s] = k.to(c["k"].dtype)
            c["v"][:, :s] = v.to(c["v"].dtype)
            if "taco" in c:
                st, built = c["taco"], TA.build_retrieval_state(k.to(torch.float32),
                                                                 cfg.retrieval)
                for name in ("mean", "basis", "centroids", "cell_sizes"):
                    getattr(st, name).copy_(getattr(built, name))
                st.cells[..., :s] = built.cells
            h2 = apply_norm(p["ln2"], x, cfg.norm_eps)
            x = x + mlp(p["ffn"], h2)
    x = apply_norm(params["final_norm"], x, cfg.norm_eps)
    logits = dense(params["lm_head"], x[:, -1:])[..., : cfg.vocab_size]
    return logits.to(torch.float32), cache
