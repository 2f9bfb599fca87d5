"""Elastic fault handling: the surviving-device re-mesh (mirrors
``repro.launch.elastic``).

When devices fail, only the data-parallel axes shrink: model shards must
stay complete, so the new dp size is the largest power of two that the
survivors hold beside a whole model axis, and gradient accumulation makes
up the difference to the global batch. :func:`replan_mesh` is the
reference's arithmetic; :func:`build_mesh` lays the plan over the visible
cards (or the devices given).
"""
from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.mesh import DeviceMesh, make_mesh


@dataclasses.dataclass(frozen=True)
class ElasticPlan:
    mesh_shape: tuple[int, ...]
    axis_names: tuple[str, ...]
    grad_accum_factor: int  # microbatch multiplier to preserve global batch
    dropped_devices: int


def replan_mesh(
    surviving_devices: int,
    *,
    model_shards: int = 16,
    target_dp: int = 16,
    pods: int = 1,
) -> ElasticPlan:
    """Largest power-of-two DP that fits the survivors, model axis intact."""
    if surviving_devices < model_shards:
        raise RuntimeError(
            f"cannot re-mesh: {surviving_devices} survivors < model_shards={model_shards}"
        )
    dp = surviving_devices // model_shards
    dp = 2 ** int(math.log2(dp))  # power-of-two DP keeps batch splits clean
    accum = max(1, (target_dp * pods) // dp)
    if pods > 1 and dp % pods == 0:
        shape = (pods, dp // pods, model_shards)
        names = ("pod", "data", "model")
    else:
        shape = (dp, model_shards)
        names = ("data", "model")
    return ElasticPlan(
        mesh_shape=shape,
        axis_names=names,
        grad_accum_factor=accum,
        dropped_devices=surviving_devices - dp * model_shards,
    )


def build_mesh(plan: ElasticPlan, devices=None) -> DeviceMesh:
    """The plan's mesh over ``devices`` (default: the visible cards, one a
    position, so one card holds only a plan of one device)."""
    if devices is None:
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    need = math.prod(plan.mesh_shape)
    if len(devices) < need:
        raise RuntimeError(f"need {need} devices, have {len(devices)}")
    return make_mesh(plan.mesh_shape, plan.axis_names, devices=devices[:need])
