"""Train / prefill / decode step builders and serving quantization: the
port of the JAX package's ``launch/steps.py`` on one card.

``make_train_step`` is the reference's train step op for op: a loop over
the leading microbatch axis (``torch.autograd.grad`` of ``loss_fn``),
accumulation in the policy's gradient dtype, division by the microbatch
count, optional int8 error-feedback compression, global-norm clipping and
AdamW.  The same step runs on DTensor params, moments and batches placed
by the ``dist.sharding`` trees (eagerly; DTensor places each op), and
``acc_shardings`` then keeps the accumulation buffer in those layouts.

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
from repro_torch.dist import dtensor as D
from repro_torch.dist.compression import ef_compress_tree
from repro_torch.models import lm, whisper
from repro_torch.models.common import ArchConfig
from repro_torch.models.layers import quantize_dense_for_serving
from repro_torch.optim import adamw_update, clip_by_global_norm
from repro_torch.tree import tree_flatten, tree_map

Params = Any


def model_module(cfg: ArchConfig):
    return whisper if cfg.family == "audio" else lm


def train_dtype_policy(cfg: ArchConfig):
    """(param_dtype, moment_dtype, grad_accum_dtype), the reference's:
    bfloat16 storage everywhere above 50B parameters (the update math
    stays float32 inside ``adamw_update``), float32 below."""
    if cfg.n_params() > 5e10:
        return torch.bfloat16, torch.bfloat16, torch.bfloat16
    return torch.float32, torch.float32, torch.float32


def quantize_tree_for_serving(params: Params, bits: int) -> Params:
    """Walk the param tree converting every dense 'w' (2-D+) to int codes,
    and every bare MoE expert bank (``w_gate``/``w_up``/``w_down`` of 3 or
    more dims) likewise, per expert and output column, as the reference
    does ("quantize expert banks too").

    Norm gains, biases, learned positions and the embedding table stay
    float (the table is gather-indexed, and the tied head reads it in the
    compute dtype).  A tree whose banks are already codes
    (:func:`init_serving_params`) passes through unchanged there.
    """
    def walk(tree, path=()):
        if isinstance(tree, dict):
            if "w" in tree and isinstance(tree["w"], torch.Tensor) \
                    and tree["w"].ndim >= 2 \
                    and not any(p in ("gnorm",) for p in path):
                return quantize_dense_for_serving(tree, bits)
            return {k: walk(v, path + (k,)) for k, v in tree.items()}
        if path and path[-1] in ("w_gate", "w_up", "w_down") \
                and isinstance(tree, torch.Tensor) and tree.ndim >= 3:
            return quantize_dense_for_serving({"w": tree}, bits)
        return tree

    return walk(params)


def init_serving_params(gen: torch.Generator, cfg: ArchConfig, bits: int,
                        device: DeviceLike = None) -> Params:
    """``quantize_tree_for_serving(init_params(gen, cfg, device), bits)``
    (``init_params`` alone at bits 0), with MoE expert banks quantized one
    expert at a time as they are drawn: the same draws and the same codes,
    without a layer's float banks on the device at once (19.3 GB for a
    grok-1 layer, 53.6 GB for arctic's)."""
    mod = model_module(cfg)
    if bits and cfg.moe_experts:
        params = mod.init_params(gen, cfg, device, expert_bits=bits)
    else:
        params = mod.init_params(gen, cfg, device)
    return quantize_tree_for_serving(params, bits) if bits else params


# ---------------------------------------------------------------------------
# Training
# ---------------------------------------------------------------------------
def _acc_buffer(p: torch.Tensor, dtype: torch.dtype, layout=None):
    """A zero gradient buffer for leaf ``p``: a plain tensor for a plain
    leaf; for a DTensor leaf a DTensor in ``layout``'s placements (a
    :class:`~repro_torch.dist.sharding.NamedSharding`), else ``p``'s."""
    if not D.is_dtensor(p):
        return torch.zeros(p.shape, dtype=dtype, device=p.device)
    # zeros_like keeps the leaf's local device (meta in the dry run)
    buf = torch.zeros_like(p, dtype=dtype)
    if layout is None or tuple(layout.placements) == tuple(p.placements):
        return buf
    return buf.redistribute(layout.mesh, layout.placements)


def make_train_step(cfg: ArchConfig, *, compress_pod_grads: bool = False,
                    lr: float = 1e-4, acc_shardings=None,
                    grad_dtype=None) -> Callable:
    """Returns train_step(params, opt_state, batch[, residuals]) ->
    (params, opt_state, loss[, residuals]).

    batch tensors are pre-microbatched: (n_micro, mb, ...).  Each
    microbatch's gradients (``torch.autograd.grad`` of ``loss_fn``) add
    into buffers of the policy's gradient dtype (or ``grad_dtype``), which
    are divided by ``n_micro``; with ``compress_pod_grads`` and residuals
    given, they pass through ``ef_compress_tree``; then
    ``clip_by_global_norm(grads, 1.0)`` and ``adamw_update(..., lr,
    weight_decay=0.1)``.  ``loss`` is the mean of the microbatch losses,
    a 0-d float32 tensor.  Nothing waits for the device.

    ``params`` must not hold a serving head copy (``embed_head``, see
    ``lm.with_head_copy``): the update would leave it stale.

    On DTensor params (and batches) the same step runs sharded.  The
    accumulation buffers are DTensors in the params' layouts, or in
    ``acc_shardings`` (a tree of :class:`~repro_torch.dist.sharding.NamedSharding`,
    usually the moments' layouts): each microbatch's gradients are
    redistributed into them, ``Partial`` -> ``Shard`` a reduce-scatter,
    the reference's accumulate-then-reduce-once pattern.  On plain tensors
    (one device) ``acc_shardings`` picks no layout and is ignored, as a
    sharding constraint on one device is the identity.
    """
    mod = model_module(cfg)

    _, _, gdtype = train_dtype_policy(cfg)
    if grad_dtype is not None:
        gdtype = grad_dtype

    def train_step(params, opt_state, batch, residuals=None):
        if "embed_head" in params:
            raise ValueError("params hold a serving head copy (embed_head) "
                             "that an update would leave stale; train on "
                             "the tree without it")
        with D.implicit(params, batch):
            return _step(params, opt_state, batch, residuals)

    def _step(params, opt_state, batch, residuals):
        leaves, unflatten = tree_flatten(params)
        live = [p.detach().requires_grad_(True) for p in leaves]
        tree = unflatten(live)
        layouts = [None] * len(leaves)
        if acc_shardings is not None and D.any_dtensor(params):
            layouts = tree_flatten(acc_shardings)[0]
            if len(layouts) != len(leaves):
                raise ValueError(f"acc_shardings has {len(layouts)} "
                                 f"leaves, params {len(leaves)}")
        acc = [_acc_buffer(p, gdtype, lay) for p, lay in zip(leaves, layouts)]
        n_micro = tree_flatten(batch)[0][0].shape[0]
        losses = []
        for i in range(n_micro):
            loss = mod.loss_fn(tree, tree_map(lambda t: t[i], batch), cfg)
            grads = torch.autograd.grad(loss, live)
            for a, g in zip(acc, grads):
                a.add_(D.like(g.to(a.dtype), a))
            losses.append(loss.detach())
        del tree, live
        # a true division on every device (CUDA divides by a Python scalar
        # as a multiply by its reciprocal)
        grads = unflatten([torch.div(a, torch.full((), float(n_micro),
                                                   dtype=a.dtype,
                                                   device=a.device))
                           for a in acc])
        del acc

        new_res = residuals
        if compress_pod_grads and residuals is not None:
            grads, new_res = ef_compress_tree(grads, residuals)

        grads, _ = clip_by_global_norm(grads, 1.0)
        params, opt_state = adamw_update(params, grads, opt_state, lr,
                                         weight_decay=0.1)
        loss = torch.stack(losses).mean()
        if D.is_dtensor(loss):
            loss = loss.full_tensor()
        if residuals is None:
            return params, opt_state, loss
        return params, opt_state, loss, new_res

    return train_step


# ---------------------------------------------------------------------------
# Serving
# ---------------------------------------------------------------------------
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
    (:meth:`step`) runs every layer, writes the cache's k/v rows and SSM
    state in place, copies every leaf the eager step returns as a new
    tensor (the advanced lengths) back into the static cache, and writes
    the greedy next tokens into :attr:`tokens`; :attr:`logits` holds the
    step's (B, V) logits until the next replay.  Any family's cache tree
    works: ``attn`` (k/v or MLA's latent), ``mamba`` and ``shared``, and
    whisper's ``self`` and ``cross``.  The graph is captured once, after
    eager warm-up steps on the capture's side stream; :meth:`reset`
    empties the cache for a new generation (whisper: a new utterance,
    whose cross k/v it copies into the captured cross leaves).
    :attr:`graph` is the :class:`CapturedGraph` (its launch record,
    replays and ``pool_bytes``: the memory its private pool reserved at
    capture)."""

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
        static = tree_flatten(self.cache)[0]

        def step(tokens):
            logits, new_cache = mod.decode_step(params, tokens, self.cache,
                                                cfg)
            for old, new in zip(static, tree_flatten(new_cache)[0]):
                if new is not old:
                    old.copy_(new)
            tokens.copy_(greedy(logits, cfg)[:, None])
            return logits

        self.graph = CapturedGraph(step, (self.tokens,),
                                   pool=torch.cuda.graph_pool_handle(),
                                   stream=torch.cuda.Stream(dev))
        (self.logits,) = self.graph.outputs
        self.reset()

    def reset(self, cross: Optional[Params] = None) -> None:
        """Empty the cache: zero every leaf (k, v, SSM state, lengths, a
        previous utterance's cross k/v).  ``cross`` (whisper's
        ``build_cross_cache`` output, {"k", "v"} of the cross leaves'
        shapes) is then copied into the cross leaves in place."""
        for t in tree_flatten(self.cache)[0]:
            t.zero_()
        if cross is not None:
            for name in ("k", "v"):
                self.cache["cross"][name].copy_(cross[name])
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
