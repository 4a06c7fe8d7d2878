"""Deterministic synthetic datasets (offline container — no CIFAR/MiniImageNet).

The port's own copy of the JAX package's ``data/synthetic.py``, pure numpy,
so both packages produce identical images from the same seed.

The image generator mirrors the *statistical role* of the paper's data: a
class is a random smooth prototype image plus instance noise and geometric
jitter, so (i) a backbone must actually learn features to separate classes,
(ii) base-class pretraining transfers to held-out novel classes — the FSL
transfer the paper evaluates.  Base classes (backbone pretraining) and novel
classes (support/query episodes) are disjoint by construction, as in
MiniImageNet→CIFAR-10 in the paper.

Everything is a pure function of (seed, index) — restart-safe, shardable by
range, no state on the host (the data-pipeline property that matters at
1000-node scale).
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

IMG = 32


def _class_prototype(rng: np.random.Generator, img: int = IMG) -> np.ndarray:
    """Smooth random low-frequency image in [0,1]^3 — the class identity."""
    base = rng.normal(size=(img // 4, img // 4, 3))
    up = np.kron(base, np.ones((4, 4, 1)))
    k = np.array([0.25, 0.5, 0.25])
    for ax in (0, 1):
        up = np.apply_along_axis(lambda m: np.convolve(m, k, mode="same"), ax, up)
    up = (up - up.min()) / max(float(np.ptp(up)), 1e-6)
    return up.astype(np.float32)


class SyntheticImages:
    """index-addressable (image, label) source with disjoint class splits."""

    def __init__(self, n_base: int = 32, n_novel: int = 10, seed: int = 0,
                 img: int = IMG, signal: float = 1.0, noise: float = 0.15):
        """``signal`` scales class-identity contrast toward a shared 0.5
        background; ``noise`` is per-pixel instance noise.  Lower
        signal/noise ratios make the task harder — bit-width benchmarks use
        a hard setting so low-precision activations genuinely lose the
        class-distinguishing detail (paper Table II's collapse row)."""
        self.img = img
        self.signal, self.noise = signal, noise
        self.n_base, self.n_novel = n_base, n_novel
        rng = np.random.default_rng(seed)
        self.protos = np.stack([_class_prototype(rng, img)
                                for _ in range(n_base + n_novel)])

    def sample(self, cls: int, idx: int) -> np.ndarray:
        """Deterministic instance `idx` of class `cls`."""
        rng = np.random.default_rng(hash((cls, idx)) % (2**32))
        im = 0.5 + self.signal * (self.protos[cls] - 0.5)
        # geometric jitter: roll by a few pixels
        im = np.roll(im, rng.integers(-3, 4, size=2), axis=(0, 1))
        if rng.random() < 0.5:
            im = im[:, ::-1]
        im = im + rng.normal(scale=self.noise, size=im.shape).astype(np.float32)
        return np.clip(im, 0.0, 1.0).astype(np.float32)

    def batch(self, classes: np.ndarray, idxs: np.ndarray
              ) -> Tuple[np.ndarray, np.ndarray]:
        x = np.stack([self.sample(int(c), int(i)) for c, i in zip(classes, idxs)])
        return x, classes.astype(np.int32)

    def base_batch(self, rng: np.random.Generator, batch: int):
        classes = rng.integers(0, self.n_base, size=batch)
        idxs = rng.integers(0, 10_000, size=batch)
        return self.batch(classes, idxs)

    def episode(self, rng: np.random.Generator, n_way: int, k_shot: int,
                n_query: int) -> Dict[str, np.ndarray]:
        """n-way k-shot episode over NOVEL classes only."""
        ways = rng.choice(np.arange(self.n_base, self.n_base + self.n_novel),
                          size=n_way, replace=False)
        sup_x, sup_y, qry_x, qry_y = [], [], [], []
        for w_i, cls in enumerate(ways):
            idxs = rng.integers(0, 10_000, size=k_shot + n_query)
            xs, _ = self.batch(np.full(k_shot + n_query, cls), idxs)
            sup_x.append(xs[:k_shot])
            qry_x.append(xs[k_shot:])
            sup_y += [w_i] * k_shot
            qry_y += [w_i] * n_query
        return {"support_x": np.concatenate(sup_x),
                "support_y": np.asarray(sup_y, np.int32),
                "query_x": np.concatenate(qry_x),
                "query_y": np.asarray(qry_y, np.int32)}


def token_lm_batch(seed: int, batch: int, seq: int, vocab: int
                   ) -> Dict[str, np.ndarray]:
    """Markov-chain token stream for LM examples: learnable but nontrivial.

    The reference's function draw for draw: the same seed gives the same
    int32 ``tokens`` and ``labels`` (``tokens`` shifted by one)."""
    rng = np.random.default_rng(seed)
    # sparse row-stochastic transition structure shared across the run
    trans_rng = np.random.default_rng(1234)
    fanout = 4
    nxt = trans_rng.integers(0, vocab, size=(vocab, fanout))
    toks = np.empty((batch, seq + 1), np.int64)
    toks[:, 0] = rng.integers(0, vocab, size=batch)
    choices = rng.integers(0, fanout, size=(batch, seq))
    for t in range(seq):
        toks[:, t + 1] = nxt[toks[:, t], choices[:, t]]
    return {"tokens": toks[:, :-1].astype(np.int32),
            "labels": toks[:, 1:].astype(np.int32)}
