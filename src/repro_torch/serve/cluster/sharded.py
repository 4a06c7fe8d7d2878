"""Sharded NCM head — prototype rows spread across ranks, backbone
replicated.

Counterpart of the JAX package's ``serve/cluster/sharded.py``.  At "many
tenants × many classes" scale the (Q, C) similarity against the prototype
matrix is the part of serving that grows without bound, and the reference
splits the prototype ROWS over a 1-D device mesh.  Here the mesh is one of
ranks (:func:`repro_torch.dist.sharding.serve_mesh` over the caller's
process group): the queries are replicated (every rank passes the same
ones), the prototype rows are padded to a multiple of ``HEAD_COLS x
n_dev``, each rank runs :func:`~repro_torch.serve.store.head_sims` on its
own row block, and the blocks are gathered along the class axis and the
padding sliced off.  Every similarity is still one dot product over the
full feature dim, in a tile of the serial head's shape in a batched
product of the serial head's batch count, so the sharded head equals the
serial one bit for bit.

On one device ``serve_mesh`` returns ``None`` and the head is the serial
computation the :class:`~repro_torch.serve.store.PrototypeStore` does.  A
sharded head is SPMD: every rank of the mesh calls :meth:`ShardedNCMHead.sims`
(or its store's ``classify``) with the same arguments, in the same order.
"""

from __future__ import annotations

from typing import Any, List, Optional

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.device import DeviceLike
from repro_torch.dist import act_sharding
from repro_torch.dist.sharding import serve_mesh
from repro_torch.serve.store import HEAD_COLS, PrototypeStore, head_sims

__all__ = ["ShardedNCMHead", "ShardedStore"]


def _f32(x: Any, device: Optional[torch.device] = None) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(device or x.device, torch.float32)
    return torch.as_tensor(np.asarray(x, np.float32), device=device)


class ShardedNCMHead:
    """Batched NCM similarity with class/tenant prototype rows split across
    the ranks of a 1-D ``("model",)`` mesh — on one device, the serial
    head.

    ``sims(queries, means)`` returns the (Q, C) cosine similarities as a
    tensor on the queries' device, the same on every rank.
    """

    AXIS = "model"
    QUERY_RULE = "serve/query_rows"

    def __init__(self, devices: Optional[List] = None):
        self.mesh = serve_mesh(devices, self.AXIS)    # None: one device
        self.n_dev = 1 if self.mesh is None else self.mesh.size()

    def sims(self, query_features, means) -> torch.Tensor:
        """(Q, D) queries × (C, D) prototype means -> (Q, C) cosine sims,
        bit for bit the serial store's :func:`head_sims`."""
        q = act_sharding.constrain(_f32(query_features), self.QUERY_RULE)
        m = _f32(means, q.device)
        c = m.shape[0]
        if self.mesh is None or c == 0:
            return head_sims(q, m)
        pad = (-c) % (HEAD_COLS * self.n_dev)
        if pad:
            m = torch.cat([m, m.new_zeros((pad, m.shape[1]))])
        rows = m.shape[0] // self.n_dev
        rank = self.mesh.get_local_rank(self.AXIS)
        block = head_sims(q, m[rank * rows:(rank + 1) * rows])
        parts = [torch.empty_like(block) for _ in range(self.n_dev)]
        dist.all_gather(parts, block.contiguous(),
                        group=self.mesh.get_group(self.AXIS))
        return torch.cat(parts, dim=1)[:, :c]


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
