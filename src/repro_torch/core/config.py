"""Configuration for subspace-collision methods (TaCo, SuCo and ablations).

A field-for-field copy of ``repro.core.config``: the port keeps its own so
that it imports nothing of the JAX package.

  method      transform   activation   selection
  ---------   ---------   ----------   -----------
  TaCo        entropy     sort (SDA)   query_aware
  SuCo        none        linear (DA)  fixed
  SuCo-DT     entropy     linear (DA)  fixed
  SuCo-CS     none        linear (DA)  query_aware
  SuCo-QS     none        sort (SDA)   query_aware
"""
from __future__ import annotations

import dataclasses
import math


@dataclasses.dataclass(frozen=True)
class SCConfig:
    """Parameters of the subspace-collision framework (paper Table 1)."""

    n_subspaces: int = 6  # N_s
    subspace_dim: int = 8  # s
    n_clusters: int = 1024  # K (total IMI cells; sqrt(K) per half)
    kmeans_iters: int = 10  # t
    alpha: float = 0.05  # collision ratio
    beta: float = 0.005  # re-rank ratio
    k: int = 50  # result count
    transform: str = "entropy"  # 'entropy' (TaCo) | 'none' (SuCo)
    activation: str = "sort"  # 'sort' | 'heap' | 'linear'
    selection: str = "query_aware"  # 'query_aware' | 'fixed'
    kmeans_init: str = "random"  # 'random' | 'kmeans++'
    candidate_cap: int | None = None  # None → auto from beta & k
    seed: int = 0
    use_kernels: bool = False  # route hot loops through the CUDA kernels
    #: 'gather' | 'masked_full' | 'auto' (see repro.core.config)
    rerank: str = "gather"
    #: 'f32' | 'bf16': bf16 rounds the centroid-distance inputs and the
    #: re-rank operands through bfloat16; accumulation stays f32.
    precision: str = "f32"

    def __post_init__(self):
        if self.precision not in ("f32", "bf16"):
            raise ValueError(
                f"precision must be 'f32' or 'bf16', got {self.precision!r}"
            )

    @property
    def sqrt_k(self) -> int:
        r = math.isqrt(self.n_clusters)
        if r * r != self.n_clusters:
            raise ValueError(f"n_clusters={self.n_clusters} must be a perfect square")
        return r

    def cap_for(self, n: int) -> int:
        if self.candidate_cap is not None:
            return min(self.candidate_cap, n)
        return int(min(n, max(4 * self.k, math.ceil(4 * self.beta * n))))


def resolve_rerank(cfg: SCConfig, *, distributed: bool = False) -> str:
    """Resolve ``cfg.rerank`` to a concrete strategy for one call site:
    ``auto`` is masked_full for single-device queries, gather for
    corpus-sharded ones."""
    mode = cfg.rerank
    if mode == "auto":
        return "gather" if distributed else "masked_full"
    if mode not in ("gather", "masked_full"):
        raise ValueError(f"unknown rerank mode {mode!r}")
    return mode


def taco_config(**kw) -> SCConfig:
    return SCConfig(**{**dict(transform="entropy", activation="sort", selection="query_aware"), **kw})


def suco_config(**kw) -> SCConfig:
    return SCConfig(**{**dict(transform="none", activation="linear", selection="fixed"), **kw})


def suco_dt_config(**kw) -> SCConfig:
    return SCConfig(**{**dict(transform="entropy", activation="linear", selection="fixed"), **kw})


def suco_cs_config(**kw) -> SCConfig:
    return SCConfig(**{**dict(transform="none", activation="linear", selection="query_aware"), **kw})


def suco_qs_config(**kw) -> SCConfig:
    return SCConfig(**{**dict(transform="none", activation="sort", selection="query_aware"), **kw})


ABLATIONS = {
    "taco": taco_config,
    "suco": suco_config,
    "suco-dt": suco_dt_config,
    "suco-cs": suco_cs_config,
    "suco-qs": suco_qs_config,
}
