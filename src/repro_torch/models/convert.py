"""Parameters from plain arrays: the reference's parameter tree (numpy
arrays, e.g. ``jax.tree.map(np.asarray, repro_params)``) as the port's, so
that both packages run the same weights (as
:func:`repro_torch.core.taco.index_from_arrays` does for an index)."""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.models.model import ArchConfig, Leaf, param_layout
from repro_torch.utils import resolve_device


def params_from_arrays(tree: dict, cfg: ArchConfig,
                       device: str | torch.device = "cuda") -> dict:
    """The port's parameter tree for ``cfg`` from a nested dict of arrays
    with the reference's keys and shapes, in ``cfg.param_dtype`` (a leaf's
    own dtype where :func:`param_layout` gives one) on ``device``. Raises ValueError on a missing or extra key or a wrong
    shape."""
    dev = resolve_device(device)

    def convert(layout, node, path: str):
        if isinstance(layout, Leaf):
            arr = np.array(node, dtype=np.float32)  # a copy: the tensor may be written
            if arr.shape != tuple(layout.shape):
                raise ValueError(f"params_from_arrays: {path} has shape {arr.shape}, "
                                 f"{cfg.name} needs {tuple(layout.shape)}")
            dtype = getattr(torch, layout.dtype) if layout.dtype else cfg.pdtype
            return torch.from_numpy(arr).to(device=dev, dtype=dtype)
        if not isinstance(node, dict):
            raise ValueError(f"params_from_arrays: {path} is a leaf, {cfg.name} needs "
                             f"the keys {sorted(layout)}")
        missing, extra = sorted(set(layout) - set(node)), sorted(set(node) - set(layout))
        if missing or extra:
            raise ValueError(f"params_from_arrays: at {path or 'the root'}, missing "
                             f"{missing}, extra {extra} for {cfg.name}")
        return {k: convert(layout[k], node[k], f"{path}.{k}" if path else k) for k in layout}

    return convert(param_layout(cfg), tree, "")
