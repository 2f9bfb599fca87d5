"""whisper-medium [audio] — enc-dec (24+24 layers), conv frontend STUB:
input_specs provides precomputed frame embeddings (B, 1500, d_model)
[arXiv:2212.04356]. Learned absolute positions (no RoPE).

long_500k is SKIPPED for this arch: pure full-attention enc-dec with an
architecturally bounded decode length (DESIGN.md §Arch-applicability)."""
import dataclasses

from repro_torch.models.model import ArchConfig

CONFIG = ArchConfig(
    name="whisper-medium",
    family="audio",
    n_layers=24,  # decoder layers; + 24 encoder layers below
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    d_ff=4096,
    vocab_size=51865,
    norm="layernorm",
    mlp="gelu",
    qkv_bias=True,
    use_rope=False,
    encoder_layers=24,
    frontend="audio",
    frontend_len=1500,
)

SMOKE = dataclasses.replace(
    CONFIG, n_layers=2, encoder_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
    d_ff=128, vocab_size=512, frontend_len=16,
    compute_dtype="float32",
)
