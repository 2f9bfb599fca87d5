"""Model configurations of the port (mirrors ``repro.configs``): the ten
architectures as data, resolved by ``--arch``. ``configs/shapes.py``, the
reference's XLA dry-run shapes, has no counterpart here."""
from repro_torch.configs.registry import ARCHS, get_arch, get_smoke

__all__ = ["ARCHS", "get_arch", "get_smoke"]
