"""starcoder2-3b [dense] — GQA(kv=2), RoPE, LayerNorm+GELU [arXiv:2402.19173; hf]."""
import dataclasses

from repro_torch.models.model import ArchConfig

CONFIG = ArchConfig(
    name="starcoder2-3b",
    family="dense",
    n_layers=30,
    d_model=3072,
    n_heads=24,
    n_kv_heads=2,
    d_ff=12288,
    vocab_size=49152,
    norm="layernorm",
    mlp="gelu",
    qkv_bias=True,
    use_rope=True,
    rope_theta=100000.0,
)

SMOKE = dataclasses.replace(
    CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
    vocab_size=512, compute_dtype="float32",
)
