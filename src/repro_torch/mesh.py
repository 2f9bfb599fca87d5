"""A named grid of devices with an ambient context: the port's counterpart of
``repro.compat``'s ``make_mesh``, ``set_mesh``, ``current_mesh`` and
``axis_size``.

The reference's mesh is a ``jax.sharding.Mesh`` that ``shard_map`` maps a
function over. The port keeps the idiom of :mod:`repro_torch.core.distributed`:
one process walks the grid's positions in order, each position's work runs
on that position's ``torch.device``, and a ``psum`` over an axis becomes a
sum in position order on the first position's device. No
``torch.distributed`` process group is used, so a grid may repeat a device:
``make_mesh(shape, names)`` without devices puts every position on the
default card, as XLA's forced host devices are all views of one CPU. A grid
of distinct cards takes the same path; that placement is unverified (the
port has been run on one H100 only).

A 1-D mesh iterates as its list of devices, so it is accepted wherever
:mod:`repro_torch.core.distributed` and the sharded searcher take a list of
shard devices.
"""
from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import math

import numpy as np
import torch

from repro_torch.utils import resolve_device


@dataclasses.dataclass(frozen=True, eq=False)
class DeviceMesh:
    """``devices`` is a numpy object array of ``torch.device`` whose shape is
    the mesh's; ``axis_names`` names its axes in order."""

    devices: np.ndarray
    axis_names: tuple[str, ...]

    def __post_init__(self):
        if self.devices.ndim != len(self.axis_names) or len(set(self.axis_names)) != len(
                self.axis_names):
            raise ValueError(f"axis names {self.axis_names} do not name the axes of a "
                             f"{self.devices.shape} grid once each")

    @property
    def shape(self) -> dict[str, int]:
        """Axis name -> size, in axis order (as ``jax.sharding.Mesh.shape``)."""
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def __iter__(self):
        if self.devices.ndim != 1:
            raise ValueError(f"a {self.shape} mesh is not a list of devices; only a 1-D mesh is")
        return iter(self.devices.tolist())

    def grid(self, *groups) -> np.ndarray:
        """The devices as a grid with one axis per group of axis names (a
        group's axes flattened in the order given, as a ``PartitionSpec``
        entry of several axes is), at position 0 of every axis in no group:
        work the reference replicates over an axis is done once."""
        groups = [(g,) if isinstance(g, str) else tuple(g) for g in groups]
        named = [n for g in groups for n in g]
        unknown = [n for n in named if n not in self.axis_names]
        if unknown or len(set(named)) != len(named):
            raise ValueError(f"axes {named} are not distinct axes of the mesh {self.shape}")
        rest = [n for n in self.axis_names if n not in named]
        arr = np.transpose(self.devices, [self.axis_names.index(n) for n in named + rest])
        arr = arr[(Ellipsis,) + (0,) * len(rest)] if rest else arr
        return arr.reshape([axis_size(self, g) for g in groups])


def make_mesh(shape, names, devices=None) -> DeviceMesh:
    """A mesh of ``shape`` named ``names`` over the first ``prod(shape)`` of
    ``devices`` in row-major order; like ``jax.make_mesh`` it raises when
    fewer are given. Without ``devices`` every position is the default card
    (the counterpart of XLA's forced host devices); a device may repeat."""
    shape, names = tuple(int(s) for s in shape), tuple(names)
    need = math.prod(shape)
    if devices is None:
        card = resolve_device("cuda")
        if card.type == "cuda" and card.index is None:
            card = torch.device("cuda", torch.cuda.current_device())
        devices = [card] * need
    devices = [torch.device(d) for d in devices]
    if len(devices) < need:
        raise ValueError(f"Number of devices {len(devices)} must be >= the product of "
                         f"mesh_shape {shape}")
    arr = np.empty(need, dtype=object)
    arr[:] = devices[:need]
    return DeviceMesh(arr.reshape(shape), names)


_AMBIENT: contextvars.ContextVar[DeviceMesh | None] = contextvars.ContextVar(
    "repro_torch_mesh", default=None)


def current_mesh() -> DeviceMesh | None:
    """The mesh installed by :func:`set_mesh`, or None."""
    return _AMBIENT.get()


@contextlib.contextmanager
def set_mesh(mesh: DeviceMesh):
    """``with set_mesh(mesh):`` makes ``mesh`` the ambient mesh (what
    ``moe_impl="manual"`` runs over) in this context and thread."""
    token = _AMBIENT.set(mesh)
    try:
        yield mesh
    finally:
        _AMBIENT.reset(token)


def axis_size(mesh: DeviceMesh, name) -> int:
    """The size of axis ``name``, or the product over a tuple of names."""
    names = (name,) if isinstance(name, str) else tuple(name)
    missing = [n for n in names if n not in mesh.axis_names]
    if missing:
        raise ValueError(f"axes {missing} are not in the mesh {mesh.shape}")
    return math.prod(mesh.shape[n] for n in names)
