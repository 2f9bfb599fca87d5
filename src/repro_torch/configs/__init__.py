"""Model configurations of the port (mirrors ``repro.configs``): the ten
architectures as data, resolved by ``--arch``, and the dry runs' four
input shapes (:mod:`repro_torch.configs.shapes`)."""
from repro_torch.configs.registry import ARCHS, get_arch, get_smoke
from repro_torch.configs.shapes import SHAPES, input_specs, skip_reason

__all__ = ["ARCHS", "SHAPES", "get_arch", "get_smoke", "input_specs", "skip_reason"]
