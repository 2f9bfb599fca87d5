from repro_torch.data.io import read_vecs, write_vecs
from repro_torch.data.tokens import SyntheticTokenStream
from repro_torch.data.vectors import even_shard_total, gmm_dataset, make_queries

__all__ = ["SyntheticTokenStream", "even_shard_total", "gmm_dataset", "make_queries",
           "read_vecs", "write_vecs"]
