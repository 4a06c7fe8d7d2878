"""Nearest-Class-Mean classifier (paper Fig. 1 step 3, Fig. 5 host side).

Counterpart of the JAX package's ``fsl/ncm.py``.  The backbone emits
feature vectors; the NCM head turns support features into per-class means
and assigns each query to the nearest mean.  Features are L2-normalized
first (the EASY recipe the paper builds on).

Accumulation order is CANONICAL: per-class sums are a strict left fold over
support rows in presentation order (:func:`running_update`, a Python loop of
row adds, never a matmul or a scatter whose order is unspecified), so the
online :class:`repro_torch.serve.store.PrototypeStore` — which receives the
same rows in the same order, possibly chunked across requests — reproduces
:func:`class_means` bit-for-bit.  That also needs the row L2 norm to give a
row the same bits whatever batch it arrives in.  On the card PyTorch picks
a reduction's thread layout from the number of rows, so a row's norm can
round differently in batches of different sizes; the fold therefore
normalizes each support row on its own, as a (1, D) tensor, on whatever
device the features lie.
"""

from __future__ import annotations

from typing import Tuple

import torch


def _l2(x: torch.Tensor) -> torch.Tensor:
    norm = torch.linalg.vector_norm(x, dim=-1, keepdim=True)
    return x / torch.clamp_min(norm, 1e-8)


def running_update(sums: torch.Tensor, counts: torch.Tensor,
                   features: torch.Tensor, labels: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fold a chunk of support rows into per-class running ``(sums, counts)``.

    ``sums``: (W, D) f32 per-class sums of L2-normalized features;
    ``counts``: (W,) f32 per-class row counts; ``features``: (N, D) raw
    backbone features; ``labels``: (N,) way indices.  Returns new tensors
    (the inputs are not modified).  Rows are added STRICTLY sequentially in
    presentation order, each normalized alone (batch-invariant bits).
    """
    f = features.to(torch.float32)
    sums = sums.clone()
    counts = counts.clone()
    for row, lab in zip(f, labels.tolist()):
        sums[lab] += _l2(row[None, :])[0]
        counts[lab] += 1.0
    return sums, counts


def finalize_means(sums: torch.Tensor, counts: torch.Tensor) -> torch.Tensor:
    """(W, D) running sums + (W,) counts -> (W, D) L2-normalized means."""
    return _l2(sums / torch.clamp_min(counts[:, None], 1.0))


def class_means(features: torch.Tensor, labels: torch.Tensor,
                n_way: int) -> torch.Tensor:
    """(N, D) support features + (N,) way-labels -> (n_way, D) means."""
    d = features.shape[-1]
    sums = torch.zeros((n_way, d), dtype=torch.float32, device=features.device)
    counts = torch.zeros((n_way,), dtype=torch.float32, device=features.device)
    sums, counts = running_update(sums, counts, features, labels)
    return finalize_means(sums, counts)


def ncm_classify(query_features: torch.Tensor,
                 means: torch.Tensor) -> torch.Tensor:
    """Nearest mean in cosine distance (== L2 on normalized vectors)."""
    q = _l2(query_features.to(torch.float32))
    sims = q @ means.T
    return torch.argmax(sims, dim=-1)


def ncm_accuracy(query_features: torch.Tensor, query_labels: torch.Tensor,
                 support_features: torch.Tensor, support_labels: torch.Tensor,
                 n_way: int) -> torch.Tensor:
    means = class_means(support_features, support_labels, n_way)
    pred = ncm_classify(query_features, means)
    return (pred == query_labels.to(pred.device)).to(torch.float32).mean()
