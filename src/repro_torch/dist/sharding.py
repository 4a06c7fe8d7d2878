"""Serving-side sharding of the port: the serial halves.

Counterpart of the serving half of the JAX package's ``dist/sharding.py``.
:func:`serve_mesh` returns ``None`` for one device or fewer — the cluster's
signal to take the serial NCM head — and raises ``not_ported`` for more:
a multi-card head (``torch.distributed`` over NCCL) is not ported yet.  :func:`prototype_spec` keeps
the reference's divisibility-or-replicate rule over a plain description of
the row split, :class:`RowSplit`.

The parameter/batch/optimizer/cache sharding trees (``tree_*_shardings``,
``set_fsdp_axes``, ``set_moe_expert_axis``) are not ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Sequence

__all__ = ["RowSplit", "prototype_spec", "serve_mesh"]


@dataclasses.dataclass(frozen=True)
class RowSplit:
    """How a (C, D) prototype matrix lies over ``n_dev`` devices: its class
    rows split in ``n_dev`` equal blocks along ``axis`` (``split``), or
    replicated on every device."""

    axis: str
    n_dev: int
    split: bool


def serve_mesh(devices: Optional[Sequence[Any]] = None,
               axis: str = "model") -> Optional[Any]:
    """``None`` on one device (or none given and at most one visible): the
    serial path.  More than one device raises ``not_ported``: the sharded
    head across cards is not ported yet."""
    if devices is None:
        import torch

        n = torch.cuda.device_count() if torch.cuda.is_available() else 1
    else:
        n = len(list(devices))
    if n <= 1:
        return None
    from repro_torch.models.layers import not_ported

    raise not_ported(f"a serving mesh over {n} devices (the sharded NCM "
                     "head across cards)", "distribution")


def prototype_spec(n_rows: int, n_dev: int, axis: str = "model") -> RowSplit:
    """The row split of a (``n_rows``, D) prototype matrix over ``n_dev``
    devices: rows split over ``axis`` when their count divides the device
    count, else replicated — the reference's divisibility-or-replicate
    rule (callers pad C up to a multiple to get the split case)."""
    return RowSplit(axis, int(n_dev),
                    n_dev > 0 and n_rows > 0 and n_rows % n_dev == 0)
