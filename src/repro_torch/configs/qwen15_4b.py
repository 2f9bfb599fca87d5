"""qwen1.5-4b [dense] — QKV bias, MHA (kv=20) [hf:Qwen/Qwen1.5-4B]."""
import dataclasses

from repro_torch.models.model import ArchConfig

CONFIG = ArchConfig(
    name="qwen1.5-4b",
    family="dense",
    n_layers=40,
    d_model=2560,
    n_heads=20,
    n_kv_heads=20,
    d_ff=6912,
    vocab_size=151936,
    norm="rmsnorm",
    mlp="swiglu",
    qkv_bias=True,
    use_rope=True,
)

SMOKE = dataclasses.replace(
    CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_ff=128,
    vocab_size=512, compute_dtype="float32",
)
