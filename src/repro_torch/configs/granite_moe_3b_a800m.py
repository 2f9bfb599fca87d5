"""granite-moe-3b-a800m [moe] — 40 experts top-8, 512-wide expert FFNs
[hf:ibm-granite/granite-3.0-3b-a800m-base]."""
import dataclasses

from repro_torch.models.model import ArchConfig

CONFIG = ArchConfig(
    name="granite-moe-3b-a800m",
    family="moe",
    n_layers=32,
    d_model=1536,
    n_heads=24,
    n_kv_heads=8,
    d_ff=512,  # per-expert FFN width
    vocab_size=49155,
    norm="rmsnorm",
    mlp="swiglu",
    use_rope=True,
    n_experts=40,
    experts_per_token=8,
    moe_every=1,
)

SMOKE = dataclasses.replace(
    CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=32,
    n_experts=4, experts_per_token=2, vocab_size=512,
    compute_dtype="float32",
)
