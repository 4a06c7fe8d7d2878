"""Synthetic CIFAR-like frames from a seed.

A copy of the few-shot repository's synthetic image generator, kept with
the benchmark so the frames cannot change under it: a class is a smooth
random low-frequency image in [0, 1]^3; an instance of it is that image
rolled by up to 3 pixels each way, mirrored with probability one half, with
per-pixel Gaussian noise, clipped to [0, 1]. The same seed gives the same
frames. Instances are drawn in bulk (one call for all the noise).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def _class_prototype(rng: np.random.Generator, img: int) -> np.ndarray:
    base = rng.normal(size=(img // 4, img // 4, 3))
    up = np.kron(base, np.ones((4, 4, 1)))
    k = np.array([0.25, 0.5, 0.25])
    for ax in (0, 1):
        up = np.apply_along_axis(lambda m: np.convolve(m, k, mode="same"),
                                 ax, up)
    up = (up - up.min()) / max(float(np.ptp(up)), 1e-6)
    return up.astype(np.float32)


class Frames:
    """``n_classes`` class images from ``rng``; :meth:`draw` makes
    instances."""

    def __init__(self, rng: np.random.Generator, n_classes: int, img: int,
                 signal: float = 1.0, noise: float = 0.15):
        self.img, self.signal, self.noise = img, signal, noise
        self.protos = np.stack([_class_prototype(rng, img)
                                for _ in range(n_classes)])

    def draw(self, rng: np.random.Generator, classes: np.ndarray
             ) -> np.ndarray:
        """(n, img, img, 3) float32 instances of ``classes``."""
        n = len(classes)
        base = 0.5 + self.signal * (self.protos[classes] - 0.5)
        shifts = rng.integers(-3, 4, size=(n, 2))
        mirror = rng.random(n) < 0.5
        out = np.empty_like(base)
        for i in range(n):
            im = np.roll(base[i], tuple(shifts[i]), axis=(0, 1))
            out[i] = im[:, ::-1] if mirror[i] else im
        out += rng.normal(scale=self.noise, size=out.shape).astype(np.float32)
        return np.clip(out, 0.0, 1.0).astype(np.float32)


def labelled(rng: np.random.Generator, frames: Frames, n: int
             ) -> Tuple[np.ndarray, np.ndarray]:
    """``n`` instances of uniformly drawn classes, and their classes."""
    classes = rng.integers(0, len(frames.protos), size=n)
    return frames.draw(rng, classes), classes
