"""Graph fingerprints, the artifact half of a compile-cache key.

Counterpart of the JAX package's ``ckpt/compile_cache.py``.  Only
:func:`graph_fingerprint` is ported: for the same numpy params the port's
graph digests to the reference's string.  The persistent cache itself
(``CompileCache``: the reference serializes XLA executables) is not ported
yet; on the card it would key the warmed CUDA graphs' inputs on the
fingerprint, the device name, the torch version and the kernel library's
digest.
"""

from __future__ import annotations

import hashlib
from typing import Any

import numpy as np
import torch

from repro_torch.models.layers import not_ported

__all__ = ["CompileCache", "graph_fingerprint"]


def _hash_update_array(h, arr: Any) -> None:
    if isinstance(arr, torch.Tensor):
        arr = arr.detach().cpu().numpy()
    arr = np.ascontiguousarray(arr)
    h.update(str(arr.dtype).encode())
    h.update(repr(arr.shape).encode())
    h.update(arr.tobytes())


def graph_fingerprint(graph) -> str:
    """Content digest of a :class:`repro_torch.core.graph.Graph`: inputs,
    outputs, node ops + wiring + attrs (arrays by dtype, shape and bytes,
    anything else by ``repr``) and the raw initializer bytes.  Two graphs
    fingerprint equal iff they lower to the same program over the same
    constants; the graph's name is excluded."""
    h = hashlib.sha256()
    h.update(repr(tuple(graph.inputs)).encode())
    h.update(repr(tuple(graph.outputs)).encode())
    for node in graph.nodes:
        h.update(node.op.encode())
        h.update(repr(tuple(node.inputs)).encode())
        h.update(repr(tuple(node.outputs)).encode())
        for key in sorted(node.attrs):
            val = node.attrs[key]
            h.update(key.encode())
            if isinstance(val, (np.ndarray, torch.Tensor)):
                _hash_update_array(h, val)
            else:
                h.update(repr(val).encode())
    for name in sorted(graph.initializers):
        h.update(name.encode())
        _hash_update_array(h, graph.initializers[name])
    return h.hexdigest()[:16]


class CompileCache:
    """The reference's persistent store of compiled executables: not
    ported yet (``DeployedModel.warmup(cache=)`` raises too)."""

    def __init__(self, directory: str):
        raise not_ported("the persistent compile cache (CompileCache)",
                         "checkpoints and compile cache")
