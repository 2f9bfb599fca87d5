"""arctic-480b [moe] — 128 experts top-2 + dense residual MLP
[hf:Snowflake/snowflake-arctic-base]. bf16 params + Adafactor (DESIGN.md §4
memory budget)."""
import dataclasses

from repro_torch.models.model import ArchConfig

CONFIG = ArchConfig(
    name="arctic-480b",
    family="moe",
    n_layers=35,
    d_model=7168,
    n_heads=56,
    n_kv_heads=8,
    d_ff=4864,  # per-expert FFN width
    vocab_size=32000,
    norm="rmsnorm",
    mlp="swiglu",
    use_rope=True,
    n_experts=128,
    experts_per_token=2,
    moe_every=1,
    moe_dense_residual=True,
    dense_d_ff=14336,
    param_dtype="bfloat16",
)

SMOKE = dataclasses.replace(
    CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=64,
    dense_d_ff=128, n_experts=4, vocab_size=512,
    compute_dtype="float32", param_dtype="float32",
)
