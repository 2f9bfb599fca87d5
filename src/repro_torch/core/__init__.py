"""repro_torch.core — the TaCo subspace-collision family on PyTorch.

  build / query / query_with_stats / index_from_arrays — end-to-end TaCo
  SCConfig + taco_config/suco_config/...               — method configuration
"""
from repro_torch.core.config import (
    ABLATIONS,
    SCConfig,
    resolve_rerank,
    suco_config,
    suco_cs_config,
    suco_dt_config,
    suco_qs_config,
    taco_config,
)
from repro_torch.core.taco import (
    SCIndex,
    build,
    index_from_arrays,
    query,
    query_with_stats,
)

__all__ = [
    "ABLATIONS",
    "SCConfig",
    "SCIndex",
    "build",
    "index_from_arrays",
    "query",
    "query_with_stats",
    "resolve_rerank",
    "suco_config",
    "suco_cs_config",
    "suco_dt_config",
    "suco_qs_config",
    "taco_config",
]
