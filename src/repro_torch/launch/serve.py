"""LM decode serving with bit-width-reduced weights: prefill by stepping the
prompt through the KV cache, then batched greedy decode.

The port's counterpart of the JAX package's eager serving loop
(``examples/serve_decode.py`` ``legacy_main``, reached through
``repro.launch.serve``), with the same flags plus ``--device``::

    python -m repro_torch.launch.serve --arch qwen2.5-3b --bits 8
    python -m repro_torch.launch.serve --arch mamba2-780m --reduced --bits 4 \\
        --device cpu

``--arch`` takes every LM config of the JAX package: the dense
qwen2.5-3b, qwen3-14b, phi3-medium-14b and the MLA minicpm3-4b, the MoE
grok-1-314b and arctic-480b, the vision-language qwen2-vl-7b, the SSM
mamba2-780m, the hybrid zamba2-7b and the audio encoder-decoder
whisper-tiny.  At ``--bits 8`` or ``4`` every quantized product runs the
qmatmul kernel on the card: 7 launches per attention or MLA block and step
(MLA's ``wkv_b`` is dequantized, not a launch), 4 per MoE block's
attention and 3 per expert (every expert reads its capacity buffer, as in
the reference) and 3 for arctic's dense residual, 2 per Mamba2 block, 8
per whisper decoder block, 1 for an untied head.  MoE expert banks are
drawn straight into codes (``steps.init_serving_params``).  On the card
each step is one replay of the decode step captured as a CUDA graph
(:class:`repro_torch.launch.steps.GraphedDecodeStep`, captured once per
batch and cache length); on the CPU it runs eagerly.

whisper-tiny runs the reference's loop as it is: the loop builds no cross
cache, so its decoder attends to zero cross k/v (the reference's
``init_cache``).  :func:`generate` takes ``cross=`` (from
``whisper.build_cross_cache`` of an ``encode``) to decode an utterance.
"""

from __future__ import annotations

import argparse
import sys
import time
from collections import OrderedDict
from typing import Optional

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.launch.steps import (
    GraphedDecodeStep,
    init_serving_params,
    make_decode_step,
    model_module,
)
from repro_torch.models.common import get_config


# captured decode steps by (params, batch, cache length), most recent last;
# each holds its graph's memory pool and its KV cache
_GRAPHED: "OrderedDict" = OrderedDict()
GRAPHED_CACHE_SIZE = 4


def graphed_step(params, cfg, batch: int, max_len: int,
                 device) -> GraphedDecodeStep:
    """The memoised :class:`GraphedDecodeStep` for this params tree, batch
    and cache length (captured on first use)."""
    key = (id(params), cfg.name, batch, max_len, str(device))
    hit = _GRAPHED.get(key)
    if hit is not None and hit[0] is params:
        _GRAPHED.move_to_end(key)
        return hit[1]
    step = GraphedDecodeStep(model_module(cfg).with_head_copy(params, cfg),
                             cfg, batch, max_len, device=device)
    _GRAPHED[key] = (params, step)
    while len(_GRAPHED) > GRAPHED_CACHE_SIZE:
        _GRAPHED.popitem(last=False)
    return step


def generate(params, cfg, prompt, tokens: int, *,
             device: DeviceLike = None,
             graph: Optional[bool] = None, cross=None) -> torch.Tensor:
    """Greedy generation: (B, P) prompt ids -> (B, tokens) int32 ids.

    The prompt is stepped through the cache one token at a time (the
    small-model path of the reference loop); the token chosen at the last
    prompt position is fed back, and the ``tokens`` tokens that follow it
    are returned, as the reference returns them.  ``params`` must already
    lie on ``device`` (default: the card).  ``graph`` (default: on the
    card) replays the captured decode step; ``graph=False`` runs the eager
    step.  The two give the same tokens.  ``cross`` (whisper only) is
    copied into the cache's cross k/v before the first step; without it
    they stay zero, as in the reference's loop.
    """
    dev = resolve_device(device)
    mod = model_module(cfg)
    on = params["embed"].device
    if on.type != dev.type or (dev.index is not None and on.index != dev.index):
        raise ValueError(f"params are on {on}, expected {dev}")
    prompt = torch.as_tensor(np.asarray(prompt), dtype=torch.int32,
                             device=dev)
    B, P = prompt.shape
    if graph is None:
        graph = dev.type == "cuda"
    if graph:
        step = graphed_step(params, cfg, B, P + tokens + 1, dev)
        step.reset(cross)
        for t in range(P):
            step.step(prompt[:, t:t + 1])
        return torch.cat([step.step().clone() for _ in range(tokens)], dim=1)
    params = mod.with_head_copy(params, cfg)
    cache = mod.init_cache(cfg, B, P + tokens + 1,
                           dtype=mod.compute_dtype(cfg), device=dev)
    if cross is not None:
        for name in ("k", "v"):
            cache["cross"][name].copy_(cross[name])
    decode = make_decode_step(cfg)
    for t in range(P):
        tok, cache = decode(params, {"tokens": prompt[:, t:t + 1]}, cache)
        tok = tok[:, None]
    out = []
    for _ in range(tokens):
        tok, cache = decode(params, {"tokens": tok}, cache)
        tok = tok[:, None]
        out.append(tok)
    return torch.cat(out, dim=1)


def main(argv=None) -> torch.Tensor:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="qwen2.5-3b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--bits", type=int, default=0, choices=[0, 4, 8],
                    help="serving weight bit-width (0 = bf16)")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=8)
    ap.add_argument("--tokens", type=int, default=16)
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.reduced:
        from repro_torch.models.testing import reduce_config
        cfg = reduce_config(cfg)
    dev = resolve_device(args.device)
    mod = model_module(cfg)
    gen = torch.Generator(device=dev).manual_seed(0)
    params = init_serving_params(gen, cfg, args.bits, device=dev)
    if args.bits:
        sys.stdout.write(f"serving at w{args.bits} ("
                         f"{'packed int4' if args.bits == 4 else 'int8'} "
                         "weights)\n")
    params = mod.with_head_copy(params, cfg)

    B = args.batch
    rng = np.random.default_rng(0)
    prompt = rng.integers(0, cfg.vocab, (B, args.prompt_len))
    t0 = time.perf_counter()
    gen_ids = generate(params, cfg, prompt, args.tokens, device=dev)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    dt = time.perf_counter() - t0
    steps = args.prompt_len + args.tokens
    sys.stdout.write(
        f"generated {args.tokens} tokens x {B} seqs on {dev} in "
        f"{dt * 1e3:.0f} ms ({steps} decode steps, "
        f"{B * args.tokens / dt:.1f} tok/s)\n")
    sys.stdout.write(f"sample: {gen_ids[0][:12].cpu().numpy()}\n")
    return gen_ids


if __name__ == "__main__":
    main()
