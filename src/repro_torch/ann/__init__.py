from repro_torch.ann.index import AnnIndex

__all__ = ["AnnIndex"]
