from repro_torch.clustering.kmeans import (
    kmeans,
    kmeans_assign,
    kmeans_pairs,
    lloyd_step,
    lloyd_step_pairs,
)

__all__ = ["kmeans", "kmeans_assign", "kmeans_pairs", "lloyd_step", "lloyd_step_pairs"]
