"""jamba-1.5-large-398b [hybrid] — 1 attention : 7 mamba interleave, MoE
16 experts top-2 every other layer [arXiv:2403.19887]. bf16 params +
Adafactor (DESIGN.md §4). Group = 8 layers (the interleave period)."""
import dataclasses

from repro_torch.models.model import ArchConfig

CONFIG = ArchConfig(
    name="jamba-1.5-large-398b",
    family="hybrid",
    n_layers=72,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=24576,
    vocab_size=65536,
    norm="rmsnorm",
    mlp="swiglu",
    use_rope=False,  # jamba uses no positional encoding in attention
    mixer="hybrid",
    attn_every=8,
    attn_pos=4,
    n_experts=16,
    experts_per_token=2,
    moe_every=2,
    mamba_d_state=16,
    mamba_d_conv=4,
    mamba_expand=2,
    param_dtype="bfloat16",
)

SMOKE = dataclasses.replace(
    CONFIG, n_layers=8, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
    n_experts=4, vocab_size=512, compute_dtype="float32",
    param_dtype="float32",
)
