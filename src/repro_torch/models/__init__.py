"""Language models of the port (mirrors ``repro.models``): the dense, moe,
ssm, hybrid, audio and vlm families, with TaCo retrieval attention for
long-context decode."""
from repro_torch.models.convert import params_from_arrays
from repro_torch.models.model import (
    ArchConfig,
    decode_step,
    forward,
    init_cache,
    init_params,
    meta_params,
    param_count,
)

__all__ = [
    "ArchConfig",
    "decode_step",
    "forward",
    "init_cache",
    "init_params",
    "meta_params",
    "param_count",
    "params_from_arrays",
]
