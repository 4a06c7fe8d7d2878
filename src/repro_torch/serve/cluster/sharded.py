"""Sharded NCM head — prototype rows spread across devices, backbone
replicated.

Counterpart of the JAX package's ``serve/cluster/sharded.py``.  At "many
tenants × many classes" scale the (Q, C) similarity against the prototype
matrix is the part of serving that grows without bound, and the reference
splits the prototype ROWS over a 1-D device mesh: every device computes
its (Q, C/ndev) block against the replicated queries, each similarity one
dot product over the full feature dim, so the sharded head equals the
serial one bit for bit.

The port runs on one card, where :func:`repro_torch.dist.sharding.serve_mesh`
returns ``None`` and the head is the serial computation the
:class:`~repro_torch.serve.store.PrototypeStore` does,
:func:`~repro_torch.serve.store.head_sims` (``ncm._l2(q) @ means.T`` over
fixed blocks of query rows): the same function, bit for bit.  More than
one device raises ``not_ported``: the head across cards is not ported
yet.
"""

from __future__ import annotations

from typing import Any, List, Optional

import numpy as np
import torch

from repro_torch.device import DeviceLike
from repro_torch.dist import act_sharding
from repro_torch.dist.sharding import serve_mesh
from repro_torch.serve.store import PrototypeStore, head_sims

__all__ = ["ShardedNCMHead", "ShardedStore"]


def _f32(x: Any, device: Optional[torch.device] = None) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(device or x.device, torch.float32)
    return torch.as_tensor(np.asarray(x, np.float32), device=device)


class ShardedNCMHead:
    """Batched NCM similarity with class/tenant prototype rows split across
    devices — on one device, the serial head.

    ``sims(queries, means)`` constrains the queries through the
    ``"serve/query_rows"`` act-sharding point (the identity on one device)
    and returns the (Q, C) cosine similarities as a tensor on the queries'
    device.
    """

    AXIS = "model"
    QUERY_RULE = "serve/query_rows"

    def __init__(self, devices: Optional[List] = None):
        self.mesh = serve_mesh(devices, self.AXIS)    # None: one device
        self.n_dev = 1

    def sims(self, query_features, means) -> torch.Tensor:
        """(Q, D) queries × (C, D) prototype means -> (Q, C) cosine sims,
        bit for bit the serial store's :func:`head_sims`."""
        q = _f32(query_features)
        m = _f32(means, q.device)
        q = act_sharding.constrain(q, self.QUERY_RULE)
        return head_sims(q, m)


class ShardedStore(PrototypeStore):
    """A :class:`PrototypeStore` whose ``classify`` runs through a shared
    :class:`ShardedNCMHead`.

    Registration (the bit-for-bit incremental fold) is untouched — the
    canonical left fold is tenant state, not compute to shard — and
    ``classify`` stays bitwise equal to the serial store."""

    def __init__(self, head: ShardedNCMHead, device: DeviceLike = None):
        super().__init__(device)
        self.head = head

    def _sims(self, q: torch.Tensor, means: torch.Tensor) -> torch.Tensor:
        # classify/prime inherit the base's query-row bucketing
        return self.head.sims(q, means)
