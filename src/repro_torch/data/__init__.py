from repro_torch.data.vectors import gmm_dataset, make_queries

__all__ = ["gmm_dataset", "make_queries"]
