from repro_torch.data.vectors import even_shard_total, gmm_dataset, make_queries

__all__ = ["even_shard_total", "gmm_dataset", "make_queries"]
