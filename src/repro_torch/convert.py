"""Carry parameters across from the JAX package as numpy arrays.

The two packages cannot draw the same random weights (``jax.random`` and
``torch.Generator`` are different streams), so to compute on the same
weights the reference's tree crosses as nested dicts of numpy arrays —
built on the JAX side with ``jax.tree_util.tree_map(np.asarray, params)`` —
and becomes the port's tensors here; :func:`params_to_numpy` is the way
back (checkpoints, and holding a tree trained by the port against JAX).
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.tree import tree_map

__all__ = ["params_from_numpy", "params_to_numpy"]


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


def params_to_numpy(tree: Any) -> Any:
    """The same structure with every tensor as a host numpy array (detached
    from any autograd graph, copied off the card); other leaves as
    ``np.asarray`` gives them."""
    return tree_map(lambda v: (v.detach().cpu().numpy()
                               if isinstance(v, torch.Tensor)
                               else np.asarray(v)), tree)
