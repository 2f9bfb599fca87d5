"""granite-3-2b [dense] — GQA(kv=8) [hf:ibm-granite/granite-3.0-2b-base]."""
import dataclasses

from repro_torch.models.model import ArchConfig

CONFIG = ArchConfig(
    name="granite-3-2b",
    family="dense",
    n_layers=40,
    d_model=2048,
    n_heads=32,
    n_kv_heads=8,
    d_ff=8192,
    vocab_size=49155,
    norm="rmsnorm",
    mlp="swiglu",
    use_rope=True,
)

SMOKE = dataclasses.replace(
    CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
    vocab_size=512, compute_dtype="float32",
)
