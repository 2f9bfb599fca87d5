"""codeqwen1.5-7b [dense] — qwen1.5 arch, MHA (kv=32), QKV bias
[hf:Qwen/CodeQwen1.5-7B]."""
import dataclasses

from repro_torch.models.model import ArchConfig

CONFIG = ArchConfig(
    name="codeqwen1.5-7b",
    family="dense",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=32,
    d_ff=13440,
    vocab_size=92416,
    norm="rmsnorm",
    mlp="swiglu",
    qkv_bias=True,
    use_rope=True,
    rope_theta=1000000.0,
)

SMOKE = dataclasses.replace(
    CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_ff=128,
    vocab_size=512, compute_dtype="float32",
)
