"""Prefill / decode step builders and serving quantization: the port of the
JAX package's ``launch/steps.py`` (its serving half; no train step yet).

``make_decode_step`` is the one-token serve step with (optionally)
serving-quantized weights: the paper's bit-width lever applied where decode
pays for every byte it streams.  It runs eagerly, one Python dispatch per
op.  :class:`GraphedDecodeStep` is the same step captured as ONE CUDA graph
for a fixed (batch, cache length), the counterpart of the reference's
``jax.jit(make_decode_step(cfg))``: a replay reads the next tokens from a
static (B, 1) buffer and writes the greedy tokens back into it.
"""

from __future__ import annotations

from typing import Any, Callable, Optional

import torch

from repro_torch.core.cudagraph import CapturedGraph
from repro_torch.device import DeviceLike, resolve_device
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


def greedy(logits: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    """(B, V) logits -> (B,) int32 greedy tokens over the TRUE vocab range
    (padding excluded); argmax returns the first index among equal maxima,
    as jnp.argmax."""
    return torch.argmax(logits[..., :cfg.vocab], dim=-1).to(torch.int32)


def make_decode_step(cfg: ArchConfig) -> Callable:
    mod = model_module(cfg)

    def decode_step(params, batch, cache):
        logits, new_cache = mod.decode_step(params, batch["tokens"], cache, cfg)
        return greedy(logits, cfg), new_cache

    return decode_step


class GraphedDecodeStep:
    """The decode step captured as one CUDA graph over a static KV cache of
    ``batch`` sequences and ``max_len`` positions (on the card only).

    :attr:`tokens` is the static (B, 1) int32 input; a replay
    (:meth:`step`) runs every layer, writes the cache's k/v rows in place,
    writes the advanced length back into the static cache (the eager step
    returns it as a new tensor), and writes the greedy next tokens into
    :attr:`tokens`; :attr:`logits` holds the step's (B, V) logits until the
    next replay.  The graph is captured once, after eager warm-up steps on
    the capture's side stream; :meth:`reset` empties the cache for a new
    generation.  :attr:`graph` is the :class:`CapturedGraph` (its launch
    record, replays and ``pool_bytes``: the memory its private pool
    reserved at capture)."""

    def __init__(self, params: Params, cfg: ArchConfig, batch: int,
                 max_len: int, device: DeviceLike = None):
        dev = resolve_device(device)
        if dev.type != "cuda":
            raise ValueError(f"a CUDA graph runs on the card, not {dev}")
        mod = model_module(cfg)
        self.params, self.cfg = params, cfg
        self.batch, self.max_len = batch, max_len
        self.cache = mod.init_cache(cfg, batch, max_len,
                                    dtype=mod.compute_dtype(cfg), device=dev)
        self.tokens = torch.zeros((batch, 1), dtype=torch.int32, device=dev)
        c = self.cache["attn"]

        def step(tokens):
            logits, new_cache = mod.decode_step(params, tokens, self.cache,
                                                cfg)
            c["len"].copy_(new_cache["attn"]["len"])
            tokens.copy_(greedy(logits, cfg)[:, None])
            return logits

        self.graph = CapturedGraph(step, (self.tokens,),
                                   pool=torch.cuda.graph_pool_handle(),
                                   stream=torch.cuda.Stream(dev))
        (self.logits,) = self.graph.outputs
        self.reset()

    def reset(self) -> None:
        """Empty the cache: zero k, v and every length."""
        for t in self.cache["attn"].values():
            t.zero_()
        self.position = 0

    def step(self, tokens: Optional[torch.Tensor] = None) -> torch.Tensor:
        """One decode step on the current stream: feed ``tokens`` (B, 1)
        (default: the previous step's greedy tokens, already in
        :attr:`tokens`) and replay; returns :attr:`tokens`, now the next
        greedy tokens (a static buffer: clone what must outlive the next
        step)."""
        if self.position >= self.max_len:
            # the replay would write k/v rows past the cache
            raise RuntimeError(f"the cache holds {self.max_len} positions; "
                               "call reset() before the next generation")
        if tokens is not None:
            self.tokens.copy_(tokens)
        self.graph.replay()
        self.position += 1
        return self.tokens
