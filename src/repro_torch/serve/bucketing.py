"""Batch-shape bucketing — the shape discipline that makes dynamic batching
safe on an artifact whose warmed buckets are CUDA graphs.

A captured graph replays one fixed input shape, so a serving loop that
forwarded whatever batch the coalescer produced would run every new size
eagerly (or capture it mid-flight).  Instead every batch is padded up to a
power-of-two bucket from a fixed, warmed set, so after
:meth:`ServeEngine.warmup` every batch replays a graph and the trace counter
stays flat.  Padding is sound because the HW graph is per-sample
independent (im2col / matmul / threshold / pool / GAP never mix batch rows)
— pad rows are computed and discarded.

The port's copy of the JAX package's ``serve/bucketing.py``.  The bucket
math lives in :mod:`repro_torch.core.deploy` (``bucket_for``,
``pow2_buckets``) so ``DeployedModel.warmup`` shares it; this module adds
the array plumbing the engine needs.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np

from repro_torch.core.deploy import bucket_for, pow2_buckets

__all__ = ["bucket_for", "pad_to_bucket", "pow2_buckets"]


def pad_to_bucket(x: np.ndarray, buckets: Sequence[int]
                  ) -> Tuple[np.ndarray, int, int]:
    """Pad the leading axis of ``x`` up to its bucket with zero rows.

    Returns ``(padded, n_real, bucket)``; callers slice ``out[:n_real]``
    after execution.  Zero rows (not repeats) keep the padding visibly
    inert: a bug that mixes batch rows shows up as a hard numeric change,
    not a subtle one.
    """
    x = np.asarray(x)
    n = x.shape[0]
    b = bucket_for(n, buckets)
    if b == n:
        return x, n, b
    pad = np.zeros((b - n,) + x.shape[1:], x.dtype)
    return np.concatenate([x, pad], axis=0), n, b
