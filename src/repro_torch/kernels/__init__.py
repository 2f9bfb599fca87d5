"""Hand-written CUDA kernels of the main path (``csrc/*.cu``), each beside
its plain PyTorch version; :mod:`repro_torch.kernels.ops` picks between
them. Nothing here compiles or touches the card at import: the kernels are
built at first use (:mod:`repro_torch.kernels.cuda`)."""
from repro_torch.kernels import ops, ref

__all__ = ["ops", "ref"]
