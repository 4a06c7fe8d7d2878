"""Carry parameters across from the JAX package as numpy arrays.

The two packages cannot draw the same random weights (``jax.random`` and
``torch.Generator`` are different streams), so to compute on the same
weights the reference's tree crosses as nested dicts of numpy arrays —
built on the JAX side with ``jax.tree_util.tree_map(np.asarray, params)`` —
and becomes the port's tensors here.
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device

__all__ = ["params_from_numpy"]


def params_from_numpy(tree: Any, device: DeviceLike = None) -> Any:
    """Nested dicts (lists, tuples) of numpy arrays -> the same structure of
    tensors on ``device`` (default: the card), dtypes kept."""
    dev = resolve_device(device)

    def conv(node):
        if isinstance(node, Mapping):
            return {k: conv(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(conv(v) for v in node)
        return torch.as_tensor(np.array(node, copy=True), device=dev)

    return conv(tree)
