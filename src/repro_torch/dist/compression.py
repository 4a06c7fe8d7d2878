"""int8 gradient compression with error feedback (EF-SGD): the port of the
JAX package's ``dist/compression.py``.

Gradients are quantized to int8 before the slow hop of an all-reduce; the
quantization error accumulates in a residual that is re-injected into the
next step's gradient, so the RUNNING SUM of transmitted gradients tracks
the running sum of true gradients — the standard error-feedback guarantee.
On one card there is no hop: ``make_train_step(compress_pod_grads=True)``
applies the same quantize-dequantize to the averaged gradients, so the
arithmetic is the reference's.

The codes and scales equal the reference's bit for bit: the scale is
``max(amax / 127, 1e-12)`` and the codes ``clip(round(g / scale))`` with a
true division (not a multiply by the reciprocal) and round-half-even, as
``jnp.round`` rounds.
"""

from __future__ import annotations

from typing import Any, Tuple

import torch

from repro_torch.tree import tree_flatten, tree_map

__all__ = ["compress_int8", "decompress_int8", "init_residuals",
           "ef_compress_tree"]


def compress_int8(g: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-tensor int8 quantization: returns (codes, scale).

    ``|decompress(codes, scale) - g| <= scale / 2`` elementwise (round to
    nearest on a uniform grid).
    """
    g = g.to(torch.float32)
    amax = torch.amax(torch.abs(g))
    # tensor operands: CUDA divides by a Python scalar as a multiply by its
    # reciprocal, one bit off the reference's quotient
    scale = torch.clamp_min(
        amax / torch.full((), 127.0, dtype=torch.float32, device=g.device),
        1e-12)
    codes = torch.div(g, scale).round_().clamp_(-127, 127).to(torch.int8)
    return codes, scale


def decompress_int8(codes: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return codes.to(torch.float32) * scale


def init_residuals(grads: Any) -> Any:
    """Zero float32 residual tree matching a gradient tree."""
    return tree_map(lambda g: torch.zeros(g.shape, dtype=torch.float32,
                                          device=g.device), grads)


def ef_compress_tree(grads: Any, residuals: Any) -> Tuple[Any, Any]:
    """Error-feedback compression over a tree.

    Each leaf transmits ``C(g + r)`` (quantize-dequantize) and carries the
    error ``(g + r) - C(g + r)`` into the next step's residual.
    """

    def leaf(g, r):
        target = g.to(torch.float32) + r
        codes, scale = compress_int8(target)
        sent = decompress_int8(codes, scale)
        return sent.to(g.dtype), target - sent

    g_leaves, unflatten = tree_flatten(grads)
    r_leaves, _ = tree_flatten(residuals)
    pairs = [leaf(g, r) for g, r in zip(g_leaves, r_leaves)]
    return (unflatten([p[0] for p in pairs]),
            unflatten([p[1] for p in pairs]))
