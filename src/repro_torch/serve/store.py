"""Online prototype store — the paper's real-time few-shot loop as state.

Counterpart of the JAX package's ``serve/store.py``.  Support shots arrive
at runtime; ``register(class_id, features)`` folds them into per-class
running ``(sum, count)`` and the class is immediately servable.  The folds
go through :func:`repro_torch.fsl.ncm.running_update`, the SAME strict left
fold ``class_means`` uses, so the store is **bit-for-bit** equal to an
offline NCM over the concatenated support set presented in the same order.

The store holds features, not images.  Its sums, means and the classify
similarity live on the store's device (the card unless the caller asks for
the CPU), where the backbone's features already are; only the returned
prototypes and similarities cross to the host, as numpy.  Bookkeeping
(class order, shot counts) stays in Python.  One store per artifact —
features from different bit-width datapaths live on different grids.
"""

from __future__ import annotations

import threading
from typing import Dict, Hashable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.fsl import ncm

__all__ = ["HEAD_COLS", "HEAD_ROWS", "HEAD_TILES", "PrototypeStore",
           "head_sims"]

# Query rows of every NCM head call: a classify's rows run in blocks of
# exactly this many (the last zero-padded).  On the card PyTorch picks a row
# norm's reduction layout, and cuBLAS a GEMM, from the row count, so the
# same query could round differently in a batch of 3 and one of 8; with one
# block shape a query's similarities never depend on its batch neighbours
# (a cluster replica and a single engine answer it bit for bit alike).
HEAD_ROWS = 64
# Prototype rows of every product tile, likewise (the last tile
# zero-padded): cuBLAS also picks its kernel from N, so a class's
# similarities never depend on how many classes stand beside it, nor on
# which rank's block of a sharded head holds it.
HEAD_COLS = 64
# Tiles of every batched product (the last group zero-padded): the batched
# kernel is picked from the batch count too (on the H100 a batch of one
# tile gave other bits than a batch of several, and 8 tiles ran another,
# slower kernel than 16 or 64), so every launch is a batch of exactly this
# many, whatever the class count or the split.
HEAD_TILES = 16


def _pad_rows(t: torch.Tensor, unit: int) -> torch.Tensor:
    pad = max(1, -(-t.shape[0] // unit)) * unit - t.shape[0]
    return torch.cat([t, t.new_zeros((pad, t.shape[1]))]) if pad else t


def head_sims(q: torch.Tensor, means: torch.Tensor) -> torch.Tensor:
    """(n, D) queries × (C, D) unit prototype rows -> (n, C) cosine
    similarities, ``ncm._l2(q) @ means.T``: each block of
    :data:`HEAD_ROWS` query rows against the (:data:`HEAD_COLS`, D)
    tiles of the prototypes, :data:`HEAD_TILES` tiles a ``torch.bmm``."""
    n, c = q.shape[0], means.shape[0]
    if c == 0:
        return q.new_zeros((n, 0))
    groups = _pad_rows(means, HEAD_COLS * HEAD_TILES).reshape(
        -1, HEAD_TILES, HEAD_COLS, means.shape[1]).transpose(2, 3)
    return torch.cat([
        torch.cat([torch.bmm(b.expand(HEAD_TILES, *b.shape), g)
                   for g in groups]).transpose(0, 1).reshape(HEAD_ROWS, -1)
        for b in map(ncm._l2, _pad_rows(q, HEAD_ROWS).split(HEAD_ROWS))
    ])[:n, :c]


class PrototypeStore:
    """Thread-safe incremental Nearest-Class-Mean state.

    ``register`` rebuilds the cached prototype matrix eagerly —
    registrations are onboarding, classifies are the latency path.
    ``classify`` is one (Q, C) similarity with the query rows padded to
    blocks of :data:`HEAD_ROWS` (the reference pads to a power-of-two
    bucket; one block shape also makes a row's bits independent of its
    batch on the card).
    """

    def __init__(self, device: DeviceLike = None):
        self.device = resolve_device(device)
        self._lock = threading.RLock()
        self._sums: Dict[Hashable, torch.Tensor] = {}   # class -> (D,) f32
        self._counts: Dict[Hashable, int] = {}
        self._order: List[Hashable] = []                # registration order
        self._means: Optional[torch.Tensor] = None      # cache, (C, D)

    def _f32(self, x) -> torch.Tensor:
        if isinstance(x, torch.Tensor):
            return x.detach().to(self.device, torch.float32)
        return torch.as_tensor(np.asarray(x, np.float32), device=self.device)

    def __len__(self) -> int:
        with self._lock:
            return len(self._order)

    @property
    def class_ids(self) -> Tuple[Hashable, ...]:
        with self._lock:
            return tuple(self._order)

    def counts(self) -> Dict[Hashable, int]:
        with self._lock:
            return dict(self._counts)

    def register(self, class_id: Hashable, features) -> int:
        """Fold (k, D) backbone features into ``class_id``'s running mean;
        returns the class's new shot count.  A 1-D (D,) single shot is
        accepted as (1, D)."""
        f = self._f32(features)
        if f.ndim == 1:
            f = f[None, :]
        if f.ndim != 2 or f.shape[0] == 0:
            raise ValueError(f"features must be (k, D) with k >= 1, "
                             f"got shape {tuple(f.shape)}")
        with self._lock:
            if class_id not in self._sums:
                self._sums[class_id] = torch.zeros(
                    (f.shape[1],), dtype=torch.float32, device=self.device)
                self._counts[class_id] = 0
                self._order.append(class_id)
            elif self._sums[class_id].shape[0] != f.shape[1]:
                raise ValueError(
                    f"feature dim {f.shape[1]} != store dim "
                    f"{self._sums[class_id].shape[0]} for class {class_id!r}")
            # one-row view of the canonical fold: labels are all 0, the
            # (1, D)/(1,) carry is this class's accumulator
            sums, counts = ncm.running_update(
                self._sums[class_id][None, :],
                torch.tensor([float(self._counts[class_id])],
                             device=self.device),
                f, torch.zeros((f.shape[0],), dtype=torch.int64))
            self._sums[class_id] = sums[0]
            self._counts[class_id] = int(counts[0])
            self._rebuild_locked()
            return self._counts[class_id]

    def _rebuild_locked(self) -> None:
        sums = torch.stack([self._sums[c] for c in self._order])
        counts = torch.tensor([float(self._counts[c]) for c in self._order],
                              device=self.device)
        self._means = ncm.finalize_means(sums, counts)

    def _prototypes_locked(self) -> Tuple[torch.Tensor, Tuple[Hashable, ...]]:
        if not self._order:
            raise RuntimeError("no classes registered yet")
        if self._means is None:
            self._rebuild_locked()
        return self._means, tuple(self._order)

    def prototypes(self) -> Tuple[np.ndarray, Tuple[Hashable, ...]]:
        """(C, D) L2-normalized class means + matching class ids, in
        registration order."""
        with self._lock:
            means, ids = self._prototypes_locked()
            return means.cpu().numpy().copy(), ids

    def _sims(self, q: torch.Tensor, means: torch.Tensor) -> torch.Tensor:
        return head_sims(q, means)

    def classify(self, query_features
                 ) -> Tuple[List[Hashable], np.ndarray]:
        """NCM over the current store: (n, D) queries -> (class ids, (n, C)
        cosine similarities).  A 1-D query is accepted as one row.  The
        head runs on fixed blocks of :data:`HEAD_ROWS` query rows
        (:func:`head_sims`)."""
        q = self._f32(query_features)
        if q.ndim == 1:
            q = q[None, :]
        with self._lock:
            means, ids = self._prototypes_locked()
        sims = self._sims(q, means)
        pred = sims.argmax(dim=-1).tolist()
        return [ids[i] for i in pred], sims.cpu().numpy()

    def prime(self, dim: int, buckets: Sequence[int] = (1,)) -> None:
        """Run the classify head once ahead of traffic (the current
        prototypes when classes exist, a (1, D) dummy otherwise), so first
        requests find warm allocator and kernels.  Every call has the same
        block shape, so ``buckets`` needs no call of its own."""
        with self._lock:
            try:
                means, _ = self._prototypes_locked()
            except RuntimeError:
                means = torch.zeros((1, int(dim)), device=self.device)
        self._sims(torch.zeros((1, int(dim)), device=self.device), means)

    def reset(self) -> None:
        with self._lock:
            self._sums.clear()
            self._counts.clear()
            self._order.clear()
            self._means = None
