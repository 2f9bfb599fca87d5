"""llava-next-mistral-7b [vlm] — mistral-7b backbone; anyres tiling frontend
STUB: input_specs provides precomputed patch embeddings (B, P, d_model)
[hf:llava-hf/llava-v1.6-mistral-7b-hf]."""
import dataclasses

from repro_torch.models.model import ArchConfig

CONFIG = ArchConfig(
    name="llava-next-mistral-7b",
    family="vlm",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    vocab_size=32000,
    norm="rmsnorm",
    mlp="swiglu",
    use_rope=True,
    rope_theta=1000000.0,
    frontend="vlm",
    frontend_len=576,  # one 24x24 vision tile (anyres base)
)

SMOKE = dataclasses.replace(
    CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
    vocab_size=512, frontend_len=8, compute_dtype="float32",
)
