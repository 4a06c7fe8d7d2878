"""Prefill / decode step builders and serving quantization: the port of the
JAX package's ``launch/steps.py`` (its serving half; no train step yet).

``make_decode_step`` is the one-token serve step with (optionally)
serving-quantized weights: the paper's bit-width lever applied where decode
pays for every byte it streams.
"""

from __future__ import annotations

from typing import Any, Callable

import torch

from repro_torch.models import lm
from repro_torch.models.common import ArchConfig
from repro_torch.models.layers import not_ported, quantize_dense_for_serving

Params = Any


def model_module(cfg: ArchConfig):
    if cfg.family == "audio":
        raise not_ported("the audio family (whisper)", "encoder-decoder")
    return lm


def quantize_tree_for_serving(params: Params, bits: int) -> Params:
    """Walk the param tree converting every dense 'w' (2-D+) to int codes.

    Norm gains, biases and the embedding table stay float (the table is
    gather-indexed, and the tied head reads it in the compute dtype).  Bare
    MoE expert banks, which the reference quantizes too, belong to a later
    slice of the port and raise here.
    """
    def walk(tree, path=()):
        if isinstance(tree, dict):
            if "w" in tree and isinstance(tree["w"], torch.Tensor) \
                    and tree["w"].ndim >= 2 \
                    and not any(p in ("gnorm",) for p in path):
                return quantize_dense_for_serving(tree, bits)
            return {k: walk(v, path + (k,)) for k, v in tree.items()}
        if path and path[-1] in ("w_gate", "w_up", "w_down") \
                and getattr(tree, "ndim", 0) >= 3:
            raise not_ported("serving quantization of MoE expert banks",
                             "moe")
        return tree

    return walk(params)


def make_prefill_step(cfg: ArchConfig) -> Callable:
    mod = model_module(cfg)

    def prefill_step(params, batch):
        return mod.prefill(params, batch, cfg)

    return prefill_step


def make_decode_step(cfg: ArchConfig) -> Callable:
    mod = model_module(cfg)

    def decode_step(params, batch, cache):
        logits, new_cache = mod.decode_step(params, batch["tokens"], cache, cfg)
        # greedy next token over the TRUE vocab range (padding excluded);
        # argmax returns the first index among equal maxima, as jnp.argmax
        next_tok = torch.argmax(logits[..., :cfg.vocab], dim=-1)
        return next_tok.to(torch.int32), new_cache

    return decode_step
