"""Production mesh construction (mirrors ``repro.launch.mesh``).

The reference's pod is 256 chips as a (data 16, model 16) grid, two pods a
(pod 2, data 16, model 16) one. The port builds the same named grid of
``torch.device`` (:mod:`repro_torch.mesh`); without devices every position
is the default card, as the reference's dry runs put it on forced host
devices.
"""
from __future__ import annotations

from repro_torch.mesh import DeviceMesh, make_mesh


def make_production_mesh(*, multi_pod: bool = False, devices=None) -> DeviceMesh:
    """Single pod: (data=16, model=16) = 256 positions.
    Multi-pod:  (pod=2, data=16, model=16) = 512 positions.
    Raises when fewer ``devices`` are given than it needs."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, devices=devices)


def dp_axes(multi_pod: bool) -> tuple[str, ...]:
    """Axes that carry data parallelism (batch + ZeRO-1 + grad reduction)."""
    return ("pod", "data") if multi_pod else ("data",)
