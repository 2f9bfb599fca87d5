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

Every family of the reference runs: dense, moe (:mod:`repro_torch.models.moe`,
a dense MLP beside the experts for arctic), ssm (RWKV6) and hybrid (Mamba
and attention, :mod:`repro_torch.models.ssm`), audio (whisper's encoder
over precomputed frame embeddings, cross-attention in the decoder, learned
positions) and vlm (llava's precomputed patch embeddings as a prefix whose
logits are cut off). Whole-sequence attention in ``forward`` and
``prefill`` (causal self-attention, the encoder's non-causal
self-attention, cross-attention) goes through the flash kernel on the card
(``impl``, as in :mod:`repro_torch.kernels.ops`); see
:mod:`repro_torch.models.attention`. ``decode_step`` and ``prefill`` write
the caches in place (the reference returns new ones).
"""
from __future__ import annotations

import dataclasses

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.mesh import current_mesh
from repro_torch.models import attention as A
from repro_torch.models import moe as MOE
from repro_torch.models import ssm as S
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
    moe_dispatch_chunks: int = 1  # == DP shard count for shard-local dispatch
    moe_impl: str = "gspmd"  # gspmd | manual (expert-parallel over the ambient mesh)
    #: the mesh axes the manual MoE splits the batch over, as one flattened
    #: group (the reference's ``act_spec[0]``; ``("pod", "data")`` on the
    #: multi-pod mesh). Port-only: ``act_spec`` itself has no counterpart.
    moe_dp_axes: tuple[str, ...] = ("data",)

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




# ============================================================ layout ======
@dataclasses.dataclass(frozen=True)
class Leaf:
    """One parameter's shape and initial draw, as the reference's init:
    ``normal`` (times ``scale``), ``uniform`` on [0, 1), ``full`` (the
    constant ``scale``), ``ones``, ``zeros``, or ``a_log`` (log 1..N along
    the last axis, Mamba's A). ``dtype`` overrides the config's
    ``param_dtype`` where the reference keeps a leaf in its own (a_log is
    float32)."""

    shape: tuple
    init: str
    scale: float = 1.0
    dtype: str | None = None


def _dense_layout(d_in: int, d_out: int, bias: bool, lead: tuple = ()):
    p = {"w": Leaf((*lead, d_in, d_out), "normal", d_in**-0.5)}
    if bias:
        p["b"] = Leaf((*lead, d_out), "zeros")
    return p


def _norm_layout(d: int, kind: str, lead: tuple = ()):
    p = {"scale": Leaf((*lead, d), "ones")}
    if kind == "layernorm":
        p["bias"] = Leaf((*lead, d), "zeros")
    return p


def _attn_layout(cfg: ArchConfig, lead: tuple):
    d, hd, bias = cfg.d_model, cfg.hd, cfg.qkv_bias
    return {
        "wq": _dense_layout(d, cfg.n_heads * hd, bias, lead),
        "wk": _dense_layout(d, cfg.n_kv_heads * hd, bias, lead),
        "wv": _dense_layout(d, cfg.n_kv_heads * hd, bias, lead),
        "wo": _dense_layout(cfg.n_heads * hd, d, bias, lead),
    }


def _mlp_layout(cfg: ArchConfig, d_ff: int, bias: bool, lead: tuple):
    d = cfg.d_model
    if cfg.mlp == "swiglu":
        return {"gate": _dense_layout(d, d_ff, bias, lead),
                "up": _dense_layout(d, d_ff, bias, lead),
                "down": _dense_layout(d_ff, d, bias, lead)}
    if cfg.mlp == "gelu":
        return {"fc": _dense_layout(d, d_ff, bias, lead),
                "proj": _dense_layout(d_ff, d, bias, lead)}
    raise ValueError(cfg.mlp)


def _mamba_layout(cfg: ArchConfig, lead: tuple):
    d, n, dc = cfg.d_model, cfg.mamba_d_state, cfg.mamba_d_conv
    din = cfg.mamba_expand * d
    dt_rank = max(1, d // 16)
    return {
        "in_proj": _dense_layout(d, 2 * din, False, lead),
        "conv_w": Leaf((*lead, dc, din), "normal", dc**-0.5),
        "conv_b": Leaf((*lead, din), "zeros"),
        "x_proj": _dense_layout(din, dt_rank + 2 * n, False, lead),
        "dt_proj": _dense_layout(dt_rank, din, True, lead),
        "a_log": Leaf((*lead, din, n), "a_log", dtype="float32"),
        "d": Leaf((*lead, din), "ones"),
        "out_proj": _dense_layout(din, d, False, lead),
    }


def _rwkv_layout(cfg: ArchConfig, lead: tuple, lora_rank: int = 64):
    d, hd = cfg.d_model, cfg.rwkv_head_dim
    p = {name: _dense_layout(d, d, False, lead) for name in ("wr", "wk", "wv", "wg", "wo")}
    return dict(
        p,
        mu=Leaf((*lead, 5, d), "uniform"),  # r,k,v,w,g token-shift mixes
        w0=Leaf((*lead, d), "full", -2.0),  # decay base
        w_lora_a=Leaf((*lead, d, lora_rank), "normal", d**-0.5),
        w_lora_b=Leaf((*lead, lora_rank, d), "normal", lora_rank**-0.5),
        u=Leaf((*lead, d // hd, hd), "normal", 0.1),  # bonus
        ln_x=_norm_layout(d, "rmsnorm", lead),
    )


def _moe_layout(cfg: ArchConfig, lead: tuple):
    d, ff, e = cfg.d_model, cfg.d_ff, cfg.n_experts
    return {
        "router": Leaf((*lead, d, e), "normal", d**-0.5),
        "gate": Leaf((*lead, e, d, ff), "normal", d**-0.5),
        "up": Leaf((*lead, e, d, ff), "normal", d**-0.5),
        "down": Leaf((*lead, e, ff, d), "normal", ff**-0.5),
    }


def _sublayer_layout(cfg: ArchConfig, spec: dict, lead: tuple, cross: bool = False):
    d = cfg.d_model
    p: dict = {"ln1": _norm_layout(d, cfg.norm, lead)}
    if spec["mixer"] == "attn":
        p["attn"] = _attn_layout(cfg, lead)
        if cross:
            p["ln_x"] = _norm_layout(d, cfg.norm, lead)
            p["cross"] = _attn_layout(cfg, lead)
    elif spec["mixer"] == "mamba":
        p["mamba"] = _mamba_layout(cfg, lead)
    elif spec["mixer"] == "rwkv":
        p["rwkv"] = _rwkv_layout(cfg, lead)
    p["ln2"] = _norm_layout(d, cfg.norm, lead)
    if spec["ffn"] == "mlp":
        p["ffn"] = _mlp_layout(cfg, cfg.d_ff, cfg.qkv_bias, lead)
    elif spec["ffn"] == "channel_mix":
        p["ffn"] = {"mu": Leaf((*lead, 2, d), "uniform"),
                    "wk": _dense_layout(d, cfg.d_ff, False, lead),
                    "wv": _dense_layout(cfg.d_ff, d, False, lead),
                    "wr": _dense_layout(d, d, False, lead)}
    else:  # moe, moe_dense
        p["moe"] = _moe_layout(cfg, lead)
        if spec["ffn"] == "moe_dense":
            p["ffn"] = _mlp_layout(cfg, cfg.dense_d_ff or cfg.d_ff, False, lead)
    return p


_ENC_SPEC = {"mixer": "attn", "ffn": "mlp"}


def param_layout(cfg: ArchConfig) -> dict:
    """The parameter tree as :class:`Leaf` s: the reference's keys, with the
    blocks' leaves stacked over ``n_groups`` (the encoder's over
    ``encoder_layers``)."""
    d = cfg.d_model
    cross = cfg.encoder_layers > 0
    lead = (cfg.n_groups,)
    params = {
        "embed": {"table": Leaf((cfg.padded_vocab, d), "normal", d**-0.5)},
        "final_norm": _norm_layout(d, cfg.norm),
        "lm_head": _dense_layout(d, cfg.padded_vocab, False),
        "blocks": {f"l{i}": _sublayer_layout(cfg, spec, lead, cross)
                   for i, spec in enumerate(cfg.layer_specs())},
    }
    if cross:
        params["encoder"] = {
            "blocks": {"l0": _sublayer_layout(cfg, _ENC_SPEC, (cfg.encoder_layers,))},
            "norm": _norm_layout(d, cfg.norm),
            "pos": Leaf((cfg.frontend_len or 1500, d), "normal", 0.02),
        }
        if not cfg.use_rope:
            params["dec_pos"] = Leaf((cfg.max_positions, d), "normal", 0.02)
    return params


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
    """Seeded parameters on ``device`` in ``cfg.param_dtype`` (a leaf's own
    dtype where it has one), each drawn as its :class:`Leaf` says. Draws run
    on the generator's device."""
    dev = resolve_device(device)
    gdev = generator.device

    def draw(leaf: Leaf) -> torch.Tensor:
        f32 = dict(device=gdev, dtype=torch.float32)
        if leaf.init == "normal":
            x = torch.randn(leaf.shape, generator=generator, **f32).mul_(leaf.scale)
        elif leaf.init == "uniform":
            x = torch.rand(leaf.shape, generator=generator, **f32)
        elif leaf.init == "full":
            x = torch.full(leaf.shape, leaf.scale, **f32)
        elif leaf.init == "a_log":
            x = torch.log(torch.arange(1, leaf.shape[-1] + 1, **f32)).expand(leaf.shape)
        else:
            x = (torch.ones if leaf.init == "ones" else torch.zeros)(leaf.shape, **f32)
        dtype = getattr(torch, leaf.dtype) if leaf.dtype else cfg.pdtype
        return x.to(device=dev, dtype=dtype).contiguous()

    return map_tree(draw, param_layout(cfg))


def meta_params(cfg: ArchConfig) -> dict:
    """The parameter tree as empty ``meta`` tensors, nothing drawn: each
    leaf's shape and dtype as :func:`init_params` gives them (the port's
    ``jax.eval_shape(init_params)``). The optimizers' init runs on it."""

    def leaf(spec: Leaf) -> torch.Tensor:
        dtype = getattr(torch, spec.dtype) if spec.dtype else cfg.pdtype
        return torch.empty(spec.shape, dtype=dtype, device="meta")

    return map_tree(leaf, param_layout(cfg))


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


def _frontend(cfg: ArchConfig, batch: dict, what: str):
    """The frontend's input of ``batch`` (audio frames or vlm patch
    embeddings), or None for a token-only config; raises ValueError where
    the config needs one and the batch has none."""
    key = {"audio": "frames", "vlm": "patch_embeds"}.get(cfg.frontend)
    if key is None:
        return None
    if key not in batch:
        raise ValueError(
            f"{cfg.name}: {what} needs batch[{key!r}] (B, T, d_model), the {cfg.frontend} "
            "frontend's precomputed embeddings; a token-only batch (as the serving "
            "engine's Request gives) cannot run this config")
    return batch[key]


# ============================================================ forward =====
def _moe(cfg: ArchConfig, p, h):
    """The reference's switch: ``moe_impl="manual"`` runs
    :func:`~repro_torch.models.moe.moe_apply_manual` over the ambient mesh
    (:func:`repro_torch.mesh.set_mesh`), the batch split over
    ``cfg.moe_dp_axes``, when the batch axis divides by
    ``moe_dispatch_chunks`` (the DP shard count); tiny decode batches, and
    ``"gspmd"``, take ``moe_apply`` with that many dispatch chunks."""
    if cfg.moe_impl == "manual" and h.shape[0] % max(cfg.moe_dispatch_chunks, 1) == 0:
        mesh = current_mesh()
        if mesh is None:
            raise ValueError(f"{cfg.name}: moe_impl='manual' runs over the ambient mesh; "
                             "enter repro_torch.mesh.set_mesh(mesh) first")
        return MOE.moe_apply_manual(p, h, n_experts=cfg.n_experts,
                                    experts_per_token=cfg.experts_per_token,
                                    capacity_factor=cfg.capacity_factor, mesh=mesh,
                                    dp_axes=cfg.moe_dp_axes, ep_axis="model")
    return MOE.moe_apply(p, h, n_experts=cfg.n_experts,
                         experts_per_token=cfg.experts_per_token,
                         capacity_factor=cfg.capacity_factor,
                         dispatch_chunks=cfg.moe_dispatch_chunks)


def _ffn_seq(cfg: ArchConfig, spec, p, h):
    """The sub-layer's FFN over a sequence h (B, S, D): (y, aux)."""
    if spec["ffn"] == "mlp":
        return mlp(p["ffn"], h), 0.0
    if spec["ffn"] == "channel_mix":
        return S.rwkv6_channel_mix(p["ffn"], h, S._shift(h)), 0.0
    y, aux = _moe(cfg, p["moe"], h)
    if spec["ffn"] == "moe_dense":
        y = y + mlp(p["ffn"], h)
    return y, aux


def _rwkv_seq(cfg: ArchConfig, p, h, return_state: bool = False):
    if cfg.rwkv_chunk and h.shape[1] % cfg.rwkv_chunk == 0:
        return S.rwkv6_time_mix_seq_chunked(p, h, cfg.rwkv_head_dim, cfg.rwkv_chunk,
                                            return_state=return_state)
    return S.rwkv6_time_mix_seq(p, h, cfg.rwkv_head_dim, return_state=return_state)


def _mamba_seq(cfg: ArchConfig, p, h, return_state: bool = False):
    return S.mamba_seq(p, h, d_state=cfg.mamba_d_state, d_conv=cfg.mamba_d_conv,
                       expand=cfg.mamba_expand, return_state=return_state)


def _apply_sublayer_seq(cfg: ArchConfig, spec, p, x, aux, causal, enc_out, impl: str):
    h = apply_norm(p["ln1"], x, cfg.norm_eps)
    if spec["mixer"] == "attn":
        qc = cfg.attn_q_chunk or (2048 if x.shape[1] >= 8192 else 0)
        x = x + A.full_attention(
            p["attn"], h, n_heads=cfg.n_heads, n_kv=cfg.n_kv_heads, head_dim=cfg.hd,
            causal=causal, use_rope=cfg.use_rope, rope_theta=cfg.rope_theta,
            q_chunk=qc, impl=impl,
        )
        if enc_out is not None and "cross" in p:
            h = apply_norm(p["ln_x"], x, cfg.norm_eps)
            x = x + A.full_attention(
                p["cross"], h, n_heads=cfg.n_heads, n_kv=cfg.n_kv_heads, head_dim=cfg.hd,
                causal=False, use_rope=False, xkv=enc_out, impl=impl,
            )
    elif spec["mixer"] == "mamba":
        x = x + _mamba_seq(cfg, p["mamba"], h)
    else:  # rwkv
        x = x + _rwkv_seq(cfg, p["rwkv"], h)
    y, a = _ffn_seq(cfg, spec, p, apply_norm(p["ln2"], x, cfg.norm_eps))
    return x + y, aux + a


def _apply_group_seq(cfg: ArchConfig, specs, group_p, x, aux, causal, enc_out, impl: str):
    for i, spec in enumerate(specs):
        x, aux = _apply_sublayer_seq(cfg, spec, group_p[f"l{i}"], x, aux, causal, enc_out,
                                     impl)
    return x, aux


def _run_stack(cfg: ArchConfig, blocks, n: int, specs, x, *, causal: bool, enc_out, impl,
               remat: bool):
    """The ``n`` stacked groups over x: (x, summed aux float32). With
    ``remat`` each group is recomputed in the backward pass
    (non-reentrant ``torch.utils.checkpoint``, as ``jax.checkpoint`` wraps
    the reference's scan body)."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for group_p in _groups(blocks, n):
        args = (cfg, specs, group_p, x, aux, causal, enc_out, impl)
        if remat:
            x, aux = checkpoint(_apply_group_seq, *args, use_reentrant=False)
        else:
            x, aux = _apply_group_seq(*args)
    return x, aux


def _encode(params, cfg: ArchConfig, frames, impl: str, remat: bool):
    """Whisper-style encoder over precomputed (stub) frame embeddings
    (B, T, d_model): non-causal self-attention and an MLP a layer."""
    enc = params["encoder"]
    x = frames.to(cfg.cdtype) + enc["pos"][None, : frames.shape[1]].to(cfg.cdtype)
    enc_cfg = dataclasses.replace(cfg, mixer="attn", n_experts=0, attn_every=1, moe_every=1,
                                  n_layers=cfg.encoder_layers)
    x, _ = _run_stack(enc_cfg, enc["blocks"], cfg.encoder_layers, [_ENC_SPEC], x,
                      causal=False, enc_out=None, impl=impl, remat=remat)
    return apply_norm(enc["norm"], x, cfg.norm_eps)


def _embed_inputs(params, cfg: ArchConfig, batch: dict, what: str, impl: str,
                  remat: bool = False):
    """(x, enc_out, n_patches): the token embeddings, behind the vlm patch
    prefix and with the learned decoder positions where the config has
    them, and the audio encoder's output (or None)."""
    x = embed(params["embed"], batch["tokens"]).to(cfg.cdtype)
    inputs = _frontend(cfg, batch, what)
    enc_out, n_patches = None, 0
    if cfg.frontend == "audio":
        enc_out = _encode(params, cfg, inputs, impl, remat)
    elif cfg.frontend == "vlm":
        n_patches = inputs.shape[1]
        x = torch.cat([inputs.to(cfg.cdtype), x], dim=1)
    if not cfg.use_rope and "dec_pos" in params:
        x = x + params["dec_pos"][None, : x.shape[1]].to(cfg.cdtype)
    return x, enc_out, n_patches


def forward(params, cfg: ArchConfig, batch: dict, *, impl: str = "auto"):
    """Training/prefill forward. batch: 'tokens' (B, S), and 'frames' (B,
    T, d_model) for an audio config or 'patch_embeds' (B, P, d_model) for a
    vlm one. Returns (logits (B, S, V) float32, aux float32: the MoE
    layers' summed load-balance loss, 0 without experts). With
    ``cfg.remat``, where a parameter requires a gradient, each layer group
    is recomputed in the backward pass."""
    remat = cfg.remat and torch.is_grad_enabled() and any(
        t.requires_grad for t in tree_flatten(params)[0])
    x, enc_out, n_patches = _embed_inputs(params, cfg, batch, "forward", impl, remat)
    x, aux = _run_stack(cfg, params["blocks"], cfg.n_groups, cfg.layer_specs(), x,
                        causal=True, enc_out=enc_out, impl=impl, remat=remat)
    x = apply_norm(params["final_norm"], x, cfg.norm_eps)
    logits = dense(params["lm_head"], x)[..., : cfg.vocab_size]
    return logits[:, n_patches:].to(torch.float32), aux


# ============================================================= decode =====
def init_cache(cfg: ArchConfig, batch_size: int, max_seq: int, *, taco=False,
               enc_len: int = 0, device: str | torch.device = "cuda") -> dict:
    """Zero-initialised per-group decode cache tree on ``device``: K/V (and
    the TaCo state) for an attention sub-layer, with the encoder's
    ``enc_len`` (default ``frontend_len or 1500``) cross K/V for an
    enc-dec config; Mamba's conv window and float32 h; RWKV's x_prev,
    float32 WKV state and channel-mix x_prev."""
    dev = resolve_device(device)
    g = cfg.n_groups
    kv, hd = cfg.n_kv_heads, cfg.hd

    def zeros(shape, dtype=cfg.cdtype):
        return torch.zeros(shape, dtype=dtype, device=dev)

    cache: dict = {}
    for i, spec in enumerate(cfg.layer_specs()):
        c: dict = {}
        if spec["mixer"] == "attn":
            c["k"] = zeros((g, batch_size, max_seq, kv, hd))
            c["v"] = zeros((g, batch_size, max_seq, kv, hd))
            if cfg.encoder_layers > 0:
                tenc = enc_len or cfg.frontend_len or 1500
                c["cross_k"] = zeros((g, batch_size, tenc, kv, hd))
                c["cross_v"] = zeros((g, batch_size, tenc, kv, hd))
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
        elif spec["mixer"] == "mamba":
            din = cfg.mamba_expand * cfg.d_model
            c["conv"] = zeros((g, batch_size, cfg.mamba_d_conv - 1, din))
            c["h"] = zeros((g, batch_size, din, cfg.mamba_d_state), torch.float32)
        elif spec["mixer"] == "rwkv":
            h = cfg.d_model // cfg.rwkv_head_dim
            c["x_prev"] = zeros((g, batch_size, cfg.d_model))
            c["wkv"] = zeros((g, batch_size, h, cfg.rwkv_head_dim, cfg.rwkv_head_dim),
                             torch.float32)
        if spec["ffn"] == "channel_mix":
            c["cm_prev"] = zeros((g, batch_size, cfg.d_model))
        cache[f"l{i}"] = c
    return cache


def _apply_sublayer_step(cfg: ArchConfig, spec, p, c, x, pos):
    """One-token step. x (B,1,D); c = this sub-layer's cache for one group,
    updated in place. Returns x."""
    h = apply_norm(p["ln1"], x, cfg.norm_eps)
    if spec["mixer"] == "attn":
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
        if "cross" in p and "cross_k" in c:
            h = apply_norm(p["ln_x"], x, cfg.norm_eps)
            q = dense(p["cross"]["wq"], h).reshape(x.shape[0], 1, cfg.n_heads, cfg.hd)
            out = A._masked_softmax_out(q, c["cross_k"], c["cross_v"], causal=False)
            x = x + dense(p["cross"]["wo"], out.reshape(x.shape[0], 1, -1))
    elif spec["mixer"] == "mamba":
        y, (nconv, nh) = S.mamba_step(
            p["mamba"], h[:, 0], (c["conv"], c["h"]), d_state=cfg.mamba_d_state,
            d_conv=cfg.mamba_d_conv, expand=cfg.mamba_expand,
        )
        c["conv"].copy_(nconv)
        c["h"].copy_(nh)
        x = x + y[:, None]
    else:  # rwkv
        y, (nxp, nwkv) = S.rwkv6_time_mix_step(
            p["rwkv"], h[:, 0], (c["x_prev"], c["wkv"]), cfg.rwkv_head_dim)
        c["x_prev"].copy_(nxp)
        c["wkv"].copy_(nwkv)
        x = x + y[:, None]

    h = apply_norm(p["ln2"], x, cfg.norm_eps)
    if spec["ffn"] == "channel_mix":
        y = S.rwkv6_channel_mix(p["ffn"], h[:, 0], c["cm_prev"])
        c["cm_prev"].copy_(h[:, 0])
        return x + y[:, None]
    return x + _ffn_seq(cfg, spec, p, h)[0]


def decode_step(params, cfg: ArchConfig, cache: dict, tokens: torch.Tensor, pos):
    """Logits for one new token. tokens (B, 1); pos = number of cached
    positions (an int, or a (B,) tensor per sequence for batched serving;
    a vlm's patches count). Returns (logits (B,1,V) float32, cache), the
    cache updated in place."""
    x = embed(params["embed"], tokens).to(cfg.cdtype)
    if not cfg.use_rope and "dec_pos" in params:
        pos_b = torch.as_tensor(pos, dtype=torch.long, device=x.device).expand(x.shape[0])
        x = x + params["dec_pos"][pos_b][:, None].to(cfg.cdtype)
    specs = cfg.layer_specs()
    for g in range(cfg.n_groups):
        group_p, group_c = _at(params["blocks"], g), _at(cache, g)
        for i, spec in enumerate(specs):
            x = _apply_sublayer_step(cfg, spec, group_p[f"l{i}"], group_c[f"l{i}"], x, pos)
    x = apply_norm(params["final_norm"], x, cfg.norm_eps)
    logits = dense(params["lm_head"], x)[..., : cfg.vocab_size]
    return logits.to(torch.float32), cache


# ============================================================= prefill ====
def _prefill_attn(cfg: ArchConfig, p, c, x, enc_out, rope, impl: str):
    """An attention sub-layer's mixer over the prompt: causal self-attention
    (K/V and the TaCo state into the cache), then cross-attention over the
    encoder's output (its K/V into the cache). Returns x."""
    b, s = x.shape[:2]
    h = apply_norm(p["ln1"], x, cfg.norm_eps)
    q, k, v = A.qkv(p["attn"], h, h, cfg.n_heads, cfg.n_kv_heads, cfg.hd)
    if rope is not None:
        q = apply_rope(q, *rope)
        k = apply_rope(k, *rope)
    qc = cfg.attn_q_chunk or (2048 if s >= 8192 else 0)
    out = A.self_attention(q, k, v, causal=True, q_chunk=qc, impl=impl)
    x = x + dense(p["attn"]["wo"], out.reshape(b, s, -1))
    c["k"][:, :s] = k.to(c["k"].dtype)
    c["v"][:, :s] = v.to(c["v"].dtype)
    if "taco" in c:
        st, built = c["taco"], TA.build_retrieval_state(k.to(torch.float32), cfg.retrieval)
        for name in ("mean", "basis", "centroids", "cell_sizes"):
            getattr(st, name).copy_(getattr(built, name))
        st.cells[..., :s] = built.cells
    if enc_out is not None and "cross" in p:
        h = apply_norm(p["ln_x"], x, cfg.norm_eps)
        q, k, v = A.qkv(p["cross"], h, enc_out, cfg.n_heads, cfg.n_kv_heads, cfg.hd)
        out = A.cross_attention(q, k, v, impl=impl)
        x = x + dense(p["cross"]["wo"], out.reshape(b, s, -1))
        c["cross_k"].copy_(k)
        c["cross_v"].copy_(v)
    return x


def prefill(params, cfg: ArchConfig, batch: dict, max_seq: int, *, impl: str = "auto"):
    """Run the full prompt (behind a vlm's patches, after an audio config's
    encoder), returning (last logits (B,1,V), populated cache). For
    attention_kind == 'taco', the TaCo retrieval index over the cached keys
    is built here."""
    x, enc_out, _ = _embed_inputs(params, cfg, batch, "prefill", impl)
    b, s = x.shape[:2]
    cache = init_cache(cfg, b, max_seq, taco=cfg.attention_kind == "taco",
                       enc_len=0 if enc_out is None else enc_out.shape[1], device=x.device)
    rope = (rope_angles(torch.arange(s, device=x.device), cfg.hd, cfg.rope_theta)
            if cfg.use_rope else None)
    specs = cfg.layer_specs()
    for g in range(cfg.n_groups):
        group_p, group_c = _at(params["blocks"], g), _at(cache, g)
        for i, spec in enumerate(specs):
            p, c = group_p[f"l{i}"], group_c[f"l{i}"]
            if spec["mixer"] == "attn":
                x = _prefill_attn(cfg, p, c, x, enc_out, rope, impl)
            elif spec["mixer"] == "mamba":
                h = apply_norm(p["ln1"], x, cfg.norm_eps)
                y, (conv_buf, hstate) = _mamba_seq(cfg, p["mamba"], h, return_state=True)
                c["conv"].copy_(conv_buf)
                c["h"].copy_(hstate)
                x = x + y
            else:  # rwkv
                h = apply_norm(p["ln1"], x, cfg.norm_eps)
                y, (xprev, wkv) = _rwkv_seq(cfg, p["rwkv"], h, return_state=True)
                c["x_prev"].copy_(xprev)
                c["wkv"].copy_(wkv)
                x = x + y
            h2 = apply_norm(p["ln2"], x, cfg.norm_eps)
            if spec["ffn"] == "channel_mix":
                c["cm_prev"].copy_(h2[:, -1])
            x = x + _ffn_seq(cfg, spec, p, h2)[0]
    x = apply_norm(params["final_norm"], x, cfg.norm_eps)
    logits = dense(params["lm_head"], x[:, -1:])[..., : cfg.vocab_size]
    return logits.to(torch.float32), cache
