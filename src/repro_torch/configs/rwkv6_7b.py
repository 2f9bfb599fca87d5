"""rwkv6-7b (Finch) [ssm] — attention-free, data-dependent decay
[arXiv:2404.05892]. O(1) decode state -> runs long_500k natively.
TaCo retrieval attention is INAPPLICABLE inside the block (no KV cache to
index) — DESIGN.md §Arch-applicability."""
import dataclasses

from repro_torch.models.model import ArchConfig

CONFIG = ArchConfig(
    name="rwkv6-7b",
    family="ssm",
    n_layers=32,
    d_model=4096,
    n_heads=64,  # d_model / rwkv_head_dim
    n_kv_heads=64,
    d_ff=14336,
    vocab_size=65536,
    norm="rmsnorm",
    mixer="rwkv",
    rwkv_head_dim=64,
    use_rope=False,
)

SMOKE = dataclasses.replace(
    CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_ff=128,
    vocab_size=512, rwkv_head_dim=16, compute_dtype="float32",
)
