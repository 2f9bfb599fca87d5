"""repro_torch.core — the TaCo subspace-collision family on PyTorch.

  build / query / query_with_stats / index_from_arrays — end-to-end TaCo
  SCConfig + taco_config/suco_config/...               — method configuration
  SCLinear, build_ivf/ivf_query                        — baselines
  distributed (make_distributed_*, shard_views)        — corpus-sharded build
                                                         statistics and query
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
from repro_torch.core.ivf import build_ivf, ivf_query
from repro_torch.core.sclinear import SCLinear
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
    "SCLinear",
    "build",
    "build_ivf",
    "index_from_arrays",
    "ivf_query",
    "query",
    "query_with_stats",
    "resolve_rerank",
    "suco_config",
    "suco_cs_config",
    "suco_dt_config",
    "suco_qs_config",
    "taco_config",
]
