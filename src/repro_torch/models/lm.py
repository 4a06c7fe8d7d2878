"""Decoder LM of the dense (GQA or MLA attention), MoE, vision-language, SSM
and hybrid families: the PyTorch port of the JAX package's
``models/lm.py``.

Entry points (functions of (params, batch), as in the reference):

* ``init_params(gen, cfg, device)`` — parameter tree with stacked
  ``(n_layers, ...)`` block leaves (``blocks`` for attention blocks,
  ``mamba_blocks`` for Mamba2 blocks, and the hybrid's one
  ``shared_block``), the reference's layout, so a JAX tree carried across
  with :func:`repro_torch.convert.params_from_numpy` runs unchanged.  The
  reference scans over the stacked leaves; the port loops over layers in
  Python.  ``expert_bits`` draws MoE expert banks straight into serving
  codes (see :func:`repro_torch.launch.steps.init_serving_params`).
* ``forward(params, batch, cfg)`` — full-sequence logits and the MoE
  load-balance aux loss summed over layers (zero without MoE).  A
  vision-language batch may carry
  ``patch_embeds``, a prefix of precomputed patch embeddings.  With
  ``cfg.remat`` and gradients enabled every block is recomputed in the
  backward (``torch.utils.checkpoint``), as the reference's
  ``jax.checkpoint``.
* ``loss_fn(params, batch, cfg)`` — token cross-entropy in float32 over
  all ``vocab_padded`` logits (+ 0.01 x the aux loss): what
  ``launch.steps.make_train_step`` differentiates.
* ``prefill(params, batch, cfg)`` — last-position logits only.
* ``init_cache(cfg, B, max_len, dtype, device)`` — the decode cache: KV
  for attention blocks (``attn``; MLA's latent ``c_kv`` and rope key
  ``k_pe`` instead), conv and SSM state for Mamba2 blocks
  (``mamba``), KV for each invocation of the hybrid's shared block
  (``shared``).
* ``decode_step(params, tokens, cache, cfg)`` — one new token for every
  sequence; the cache's k/v (or latent) rows and SSM state are written in
  place.
* ``export_decode_graph`` / ``export_prefill_graph`` — the dense decode
  step and the whole-prompt forward as core Graphs for
  ``repro_torch.compile(..., recipe="lm-decode")``, ``decode_step_ref``
  their eager mirror, bit for bit with the compiled artifact.

The audio encoder-decoder (whisper) is :mod:`repro_torch.models.whisper`.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import torch

from repro_torch.core.quant import fake_quant
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.dist import dtensor as D
from repro_torch.dist.act_sharding import constrain
from repro_torch.models import layers as L
from repro_torch.models.common import ArchConfig
from repro_torch.tree import tree_flatten

Params = Dict[str, Any]


def _wspec(cfg: ArchConfig):
    return cfg.quant.weight if cfg.quant else None


def _aspec(cfg: ArchConfig):
    return cfg.quant.act if cfg.quant else None


def compute_dtype(cfg: ArchConfig) -> torch.dtype:
    return getattr(torch, cfg.compute_dtype)


def _require_family(cfg: ArchConfig) -> None:
    if cfg.family not in ("dense", "moe", "vlm", "audio", "ssm", "hybrid"):
        raise ValueError(f"unknown family {cfg.family}")


def _is_shared_slot(cfg: ArchConfig, i: int) -> bool:
    return cfg.hybrid_period > 0 and (i % cfg.hybrid_period
                                      == cfg.hybrid_period - 1)


def _layer_kinds(cfg: ArchConfig) -> List[str]:
    """Per-slot kind list: 'attn' (attn+mlp block), 'mamba', 'shared'."""
    if cfg.family == "ssm":
        return ["mamba"] * cfg.n_layers
    if cfg.family == "hybrid":
        return ["shared" if _is_shared_slot(cfg, i) else "mamba"
                for i in range(cfg.n_layers)]
    return ["attn"] * cfg.n_layers


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------
def _attn_block_init(gen: torch.Generator, cfg: ArchConfig, stack, dev,
                     expert_bits: int = 0) -> Params:
    p = {"ln1": L.rmsnorm_init(cfg.d_model, stack, dev),
         "ln2": L.rmsnorm_init(cfg.d_model, stack, dev)}
    if cfg.attention == "mla":
        p["attn"] = L.mla_init(gen, cfg, stack, dev)
    else:
        p["attn"] = L.attn_init(gen, cfg, stack, dev)
    if cfg.moe_experts:
        p["moe"] = L.moe_init(gen, cfg, stack, dev, bits=expert_bits)
    else:
        p["mlp"] = L.mlp_init(gen, cfg.d_model, cfg.d_ff, cfg.act, stack,
                              dev)
    return p


def init_params(gen: torch.Generator, cfg: ArchConfig,
                device: DeviceLike = None, *,
                expert_bits: int = 0) -> Params:
    """Embedding N(0, 0.02), RMSNorm gains 1, dense weights uniform in
    ±1/sqrt(d_in), zero biases, MoE banks as ``layers.moe_init``, Mamba2
    blocks as ``layers.mamba_init``: the reference's distributions.  The
    draws come from ``gen`` on its own device (a CUDA generator draws the
    full model on the card), then move to ``device`` (default: the card).
    ``expert_bits`` (8 or 4) stores each MoE expert bank as serving codes,
    quantized one expert at a time as it is drawn; the rest stays float."""
    dev = resolve_device(device)
    d = cfg.d_model
    embed = torch.randn((cfg.vocab_padded, d), generator=gen,
                        dtype=torch.float32, device=gen.device)
    p: Params = {"embed": embed.mul_(0.02).to(dev),
                 "final_norm": L.rmsnorm_init(d, device=dev)}
    if not cfg.tie_embeddings:
        p["lm_head"] = L.dense_init(gen, d, cfg.vocab_padded, device=dev)
    kinds = _layer_kinds(cfg)
    n_attn, n_mamba = kinds.count("attn"), kinds.count("mamba")
    if n_attn:
        p["blocks"] = _attn_block_init(gen, cfg, (n_attn,), dev,
                                       expert_bits)
    if n_mamba:
        p["mamba_blocks"] = {
            "ln": L.rmsnorm_init(d, (n_mamba,), dev),
            "mamba": L.mamba_init(gen, cfg, (n_mamba,), dev)}
    if cfg.family == "hybrid":          # ONE shared attention+MLP block
        p["shared_block"] = _attn_block_init(gen, cfg, (), dev)
    return p


def _stacked_views(tree: Params) -> List[Params]:
    """Each layer's tree of views into a tree of stacked leaves.
    ``unbind`` makes them: its backward stacks the layers' gradients into
    one leaf gradient, where one select per layer would add a full-size
    leaf per layer."""
    leaves, unflatten = tree_flatten(tree)
    # a DTensor leaf whose layer axis is sharded is gathered first (unbind
    # has no strategy along a sharded dim)
    per_leaf = [D.unshard(leaf, (0,)).unbind(0) for leaf in leaves]
    return [unflatten([views[i] for views in per_leaf])
            for i in range(len(per_leaf[0]))]


# ---------------------------------------------------------------------------
# Blocks, embedding, head
# ---------------------------------------------------------------------------
def _attn_half(p: Params, x: torch.Tensor, cfg: ArchConfig,
               positions: torch.Tensor, cache=None, positions3=None):
    """The block's attention branch (GQA or MLA): (its output, the new
    cache); the reference names the output ``attn_out``."""
    h = L.rmsnorm(p["ln1"], x, cfg.norm_eps)
    if cfg.attention == "mla":
        return L.mla_attention(p["attn"], h, cfg, positions, cache=cache,
                               wspec=_wspec(cfg))
    return L.attention(p["attn"], h, cfg, positions, cache=cache,
                       positions3=positions3, wspec=_wspec(cfg))


def _mlp_half(p: Params, x: torch.Tensor, cfg: ArchConfig):
    """The block's MLP (or MoE) branch: its output on the activation grid,
    which the reference names ``mlp_out``, and the MoE aux loss (None for
    an MLP)."""
    h = L.rmsnorm(p["ln2"], x, cfg.norm_eps)
    if cfg.moe_experts:
        m, aux = L.moe(p["moe"], h, cfg, _wspec(cfg), _aspec(cfg))
    else:
        m, aux = L.mlp(p["mlp"], h, cfg.act, _wspec(cfg), _aspec(cfg)), None
    return fake_quant(m, _aspec(cfg)), aux


def _block(p: Params, x: torch.Tensor, cfg: ArchConfig,
           positions: torch.Tensor, cache=None, positions3=None):
    """(output, MoE aux or None, new cache): the reference's
    ``_attn_block``."""
    x = constrain(x, "residual")
    a, new_cache = _attn_half(p, x, cfg, positions, cache, positions3)
    x = x + a
    m, aux = _mlp_half(p, x, cfg)
    return x + m, aux, new_cache


def _attn_block(p: Params, x: torch.Tensor, cfg: ArchConfig,
                positions: torch.Tensor, cache=None, positions3=None):
    """:func:`_block` without the aux loss: (output, new cache)."""
    y, _, new_cache = _block(p, x, cfg, positions, cache, positions3)
    return y, new_cache


def _mamba_block(p: Params, x: torch.Tensor, cfg: ArchConfig, state=None):
    x = constrain(x, "residual")
    h = L.rmsnorm(p["ln"], x, cfg.norm_eps)
    y, new_state = L.mamba_apply(p["mamba"], h, cfg, state=state,
                                 wspec=_wspec(cfg))
    return x + y, new_state


def _checkpoint(fn, *args):
    from torch.utils.checkpoint import checkpoint

    # the forward draws no random numbers: no RNG state to stash
    return checkpoint(fn, *args, use_reentrant=False,
                      preserve_rng_state=False)


def _remat_block(p: Params, x: torch.Tensor, cfg: ArchConfig,
                 positions: torch.Tensor, positions3=None,
                 policy: str = ""):
    """One block with activation checkpointing, the reference's ``_remat``:
    the whole block recomputed in the backward, or with ``policy ==
    "tp_outputs"`` the attention and MLP branches recomputed separately,
    so their outputs (``attn_out``, ``mlp_out``) are the saved tensors.
    The ops are ``_block``'s, so the values and gradients are the same
    bits as without remat.  Returns (output, MoE aux or None)."""
    if policy == "tp_outputs":
        x = constrain(x, "residual")
        x = x + _checkpoint(lambda t: _attn_half(
            p, t, cfg, positions, positions3=positions3)[0], x)
        m, aux = _checkpoint(lambda t: _mlp_half(p, t, cfg), x)
        return x + m, aux
    return _checkpoint(lambda t: _block(
        p, t, cfg, positions, positions3=positions3)[:2], x)


def _run_mamba(p: Params, x: torch.Tensor, cfg: ArchConfig,
               remat: bool) -> torch.Tensor:
    if remat:
        return _checkpoint(lambda t: _mamba_block(p, t, cfg)[0], x)
    return _mamba_block(p, x, cfg)[0]


def _lookup(table: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """``table[tokens]``.  A DTensor table's vocab rows are gathered
    (FSDP), so the lookup keeps the tokens' batch sharding; it is an
    ``embedding``, not an index, whose backward (``index_put``) has no
    working DTensor strategy in torch 2.11."""
    if not D.is_dtensor(table):
        return table[tokens]
    return D.reduce_partial(torch.nn.functional.embedding(
        tokens.long(), D.unshard(table, (0,))))


def _tied_logits(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w.T`` for a tied (V, d) table; on DTensors only the model
    axis shards the vocab columns (``D.columns_on``)."""
    return torch.matmul(D.unshard(x, (-1,)), D.columns_on(w.T))


def _gold(lf: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Each position's logit of its label.  Over vocab-sharded logits the
    gather is a masked partial sum: it is reduced before the squeeze
    reshapes it."""
    return D.reduce_partial(torch.gather(lf, -1, labels.long()[..., None])
                            )[..., 0]


def _embed_tokens(p: Params, tokens: torch.Tensor,
                  cfg: ArchConfig) -> torch.Tensor:
    return _lookup(p["embed"], tokens).to(compute_dtype(cfg))


def _embed_batch(p: Params, batch: Dict[str, torch.Tensor],
                 cfg: ArchConfig) -> torch.Tensor:
    """Token embeddings, after a vision-language batch's precomputed
    ``patch_embeds`` prefix (the reference stubs the vision frontend)."""
    x = _embed_tokens(p, batch["tokens"], cfg)
    if cfg.family == "vlm" and "patch_embeds" in batch:
        x = torch.cat([batch["patch_embeds"].to(x.dtype), x], dim=1)
    return x


def _positions_for(batch, S: int, B: int, device) -> torch.Tensor:
    if "positions" in batch:
        return batch["positions"]
    return torch.arange(S, dtype=torch.int32, device=device)[None].expand(B, S)


def _positions3_for(batch, cfg: ArchConfig, positions: torch.Tensor):
    """M-RoPE position streams; text-only default t == h == w (== plain
    RoPE)."""
    if cfg.pos != "mrope":
        return batch.get("positions3")
    if "positions3" in batch:
        return batch["positions3"]
    return positions[None].expand(3, *positions.shape)


def with_head_copy(params: Params, cfg: ArchConfig) -> Params:
    """``params`` plus one copy of the tied embedding in the compute dtype,
    made once at load time: the head reads it instead of casting the
    float32 table on every step.  The cast is deterministic, so the logits
    are the same."""
    dt = compute_dtype(cfg)
    if (not cfg.tie_embeddings or params["embed"].dtype == dt
            or "embed_head" in params):
        return params
    return dict(params, embed_head=params["embed"].to(dt))


def _head(p: Params, x: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    if cfg.tie_embeddings:
        w = p.get("embed_head")
        if w is None or w.dtype != x.dtype:
            w = p["embed"].to(x.dtype)
        return constrain(_tied_logits(x, w), "logits")
    return constrain(L.dense(p["lm_head"], x, _wspec(cfg), dtype=x.dtype),
                     "logits")


# ---------------------------------------------------------------------------
# Forward, prefill
# ---------------------------------------------------------------------------
def _hybrid_forward(params: Params, x: torch.Tensor, cfg: ArchConfig,
                    positions: torch.Tensor, remat: bool) -> torch.Tensor:
    """zamba2's layout: runs of ``hybrid_period - 1`` Mamba2 blocks, each
    followed by a fresh invocation of the ONE shared attention+MLP block
    (same weights), then the trailing Mamba2 blocks."""
    run = cfg.hybrid_period - 1
    mblocks = _stacked_views(params["mamba_blocks"])
    sp = params["shared_block"]
    consumed = 0
    for _ in range(_layer_kinds(cfg).count("shared")):
        for bp in mblocks[consumed:consumed + run]:
            x = _run_mamba(bp, x, cfg, remat)
        consumed += run
        if remat:
            x, _ = _remat_block(sp, x, cfg, positions)
        else:
            x, _ = _attn_block(sp, x, cfg, positions)
    for bp in mblocks[consumed:]:
        x = _run_mamba(bp, x, cfg, remat)
    return x


def _trunk(params: Params, batch: Dict[str, torch.Tensor],
           cfg: ArchConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """The blocks' output before the final norm, and the MoE aux loss
    summed over layers (a float32 zero without MoE)."""
    _require_family(cfg)
    x = _embed_batch(params, batch, cfg)
    B, S, _ = x.shape
    positions = _positions_for(batch, S, B, x.device)
    positions3 = _positions3_for(batch, cfg, positions)
    remat = cfg.remat and torch.is_grad_enabled()
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    if cfg.family == "ssm":
        for bp in _stacked_views(params["mamba_blocks"]):
            x = _run_mamba(bp, x, cfg, remat)
    elif cfg.family == "hybrid":
        x = _hybrid_forward(params, x, cfg, positions, remat)
    else:
        for bp in _stacked_views(params["blocks"]):
            if remat:
                x, aux = _remat_block(bp, x, cfg, positions, positions3,
                                      cfg.remat_policy)
            else:
                x, aux, _ = _block(bp, x, cfg, positions,
                                   positions3=positions3)
            if aux is not None:
                aux_total = aux_total + aux
    return x, aux_total


def forward(params: Params, batch: Dict[str, torch.Tensor], cfg: ArchConfig
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (logits, MoE aux loss summed over layers)."""
    x, aux = _trunk(params, batch, cfg)
    x = L.rmsnorm(params["final_norm"], x, cfg.norm_eps)
    return _head(params, x, cfg), aux


def loss_fn(params: Params, batch: Dict[str, torch.Tensor], cfg: ArchConfig
            ) -> torch.Tensor:
    """Mean token cross-entropy, float32, plus 0.01 x the aux loss: the
    reference's ``loss_fn`` op for op.  The log-sum-exp runs over all
    ``vocab_padded`` logits, padding columns included, minus the gold
    logit (a gather), as the reference computes it; a vision prefix
    carries no loss.

    A tied head reads ``embed`` itself: a serving copy added by
    :func:`with_head_copy` (``embed_head``) is ignored here, as it would
    be stale after an update and would cut the head's gradient to the
    table."""
    params = {k: v for k, v in params.items() if k != "embed_head"}
    logits, aux = forward(params, batch, cfg)
    if cfg.family == "vlm" and "patch_embeds" in batch:
        logits = logits[:, batch["patch_embeds"].shape[1]:]
    lf = logits.to(torch.float32)
    lse = torch.logsumexp(lf, dim=-1)
    gold = _gold(lf, batch["labels"])
    ce = (lse - gold).mean()
    return ce + 0.01 * aux


def prefill(params: Params, batch: Dict[str, torch.Tensor], cfg: ArchConfig
            ) -> torch.Tensor:
    """Full-sequence forward; emits ONLY last-position logits (B, V)."""
    x, _ = _trunk(params, batch, cfg)
    x = L.rmsnorm(params["final_norm"], x[:, -1:], cfg.norm_eps)
    return _head(params, x, cfg)[:, 0]


# ---------------------------------------------------------------------------
# Decode
# ---------------------------------------------------------------------------
def init_cache(cfg: ArchConfig, B: int, max_len: int,
               dtype: torch.dtype = torch.bfloat16,
               device: DeviceLike = None) -> Params:
    """Decode cache with a leading layer axis, per family: ``attn`` and
    ``shared`` hold k, v (n, B, max_len, KV, hd) and per-layer int32
    lengths (MLA's ``attn`` holds the latent ``c_kv`` (n, B, max_len,
    kv_rank) and the rope key ``k_pe`` (n, B, max_len, rope_dim)
    instead of k and v); ``mamba`` holds the conv state (n, B, ssm_conv
    - 1, conv dim) in ``dtype`` and the SSM state (n, B, heads, head dim,
    ssm_state) in float32."""
    dev = resolve_device(device)
    kinds = _layer_kinds(cfg)
    n_attn, n_mamba = kinds.count("attn"), kinds.count("mamba")
    n_shared = kinds.count("shared")

    def zeros(*shape):
        return torch.zeros(shape, dtype=dtype, device=dev)

    def kv(n):
        return {"k": zeros(n, B, max_len, cfg.n_kv_heads, cfg.hd),
                "v": zeros(n, B, max_len, cfg.n_kv_heads, cfg.hd),
                "len": torch.zeros((n,), dtype=torch.int32, device=dev)}

    cache: Params = {}
    if n_attn:
        if cfg.attention == "mla":
            cache["attn"] = {
                "c_kv": zeros(n_attn, B, max_len, cfg.mla_kv_rank),
                "k_pe": zeros(n_attn, B, max_len, cfg.mla_rope_dim),
                "len": torch.zeros((n_attn,), dtype=torch.int32,
                                   device=dev)}
        else:
            cache["attn"] = kv(n_attn)
    if n_mamba:
        di, N = cfg.d_inner, cfg.ssm_state
        conv_dim = di + 2 * cfg.ssm_groups * N
        cache["mamba"] = {
            "conv": zeros(n_mamba, B, cfg.ssm_conv - 1, conv_dim),
            "ssm": torch.zeros((n_mamba, B, di // cfg.ssm_head_dim,
                                cfg.ssm_head_dim, N), dtype=torch.float32,
                               device=dev)}
    if n_shared:
        cache["shared"] = kv(n_shared)
    return cache


def _kv_layer(c: Params, i: int) -> Params:
    """Layer ``i``'s view of a stacked attention cache (k/v or MLA's
    latent, and its length)."""
    return {name: t[i] for name, t in c.items()}


def _mamba_layer(c: Params, i: int) -> Params:
    return {"conv": c["conv"][i], "ssm": c["ssm"][i]}


def _hybrid_decode(params: Params, x: torch.Tensor, cache: Params,
                   cfg: ArchConfig, positions: torch.Tensor) -> torch.Tensor:
    """One token through zamba2's layout; invocation ``s`` of the shared
    block reads and writes its own KV cache ``shared[s]``."""
    run = cfg.hybrid_period - 1
    mblocks = _stacked_views(params["mamba_blocks"])
    m = cache["mamba"]
    consumed = 0
    for s in range(_layer_kinds(cfg).count("shared")):
        for i in range(consumed, consumed + run):
            x, _ = _mamba_block(mblocks[i], x, cfg, state=_mamba_layer(m, i))
        consumed += run
        x, _ = _attn_block(params["shared_block"], x, cfg, positions,
                           cache=_kv_layer(cache["shared"], s))
    for i in range(consumed, len(mblocks)):
        x, _ = _mamba_block(mblocks[i], x, cfg, state=_mamba_layer(m, i))
    return x


def decode_step(params: Params, tokens: torch.Tensor, cache: Params,
                cfg: ArchConfig, positions: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, Params]:
    """One new token for every sequence: tokens (B, 1) -> logits (B, V).

    Positions come from the first attention (or shared-block) layer's
    cache length, kept on the device (no host sync per step); an SSM
    model has none.  The cache's k/v (or MLA latent) rows and Mamba2 state
    are updated in place; the returned cache holds the same tensors, with
    every length advanced by the new tokens (new length tensors).
    """
    _require_family(cfg)
    B, T = tokens.shape
    x = _embed_tokens(params, tokens, cfg)
    if positions is None:
        ref = cache.get("attn") or cache.get("shared")
        positions = (ref["len"][0].expand(B, 1) if ref is not None else
                     torch.zeros((B, 1), dtype=torch.int32, device=x.device))
    positions3 = _positions3_for({}, cfg, positions)
    new_cache = dict(cache)
    if cfg.family == "ssm":
        m = cache["mamba"]
        for i, bp in enumerate(_stacked_views(params["mamba_blocks"])):
            x, _ = _mamba_block(bp, x, cfg, state=_mamba_layer(m, i))
    elif cfg.family == "hybrid":
        x = _hybrid_decode(params, x, cache, cfg, positions)
        c = cache["shared"]
        new_cache["shared"] = dict(c, len=c["len"] + T)
    else:
        c = cache["attn"]
        for i, bp in enumerate(_stacked_views(params["blocks"])):
            x, _ = _attn_block(bp, x, cfg, positions, cache=_kv_layer(c, i),
                               positions3=positions3)
        new_cache["attn"] = dict(c, len=c["len"] + T)
    x = L.rmsnorm(params["final_norm"], x, cfg.norm_eps)
    return _head(params, x, cfg)[:, 0], new_cache


# ---------------------------------------------------------------------------
# Decode serving through the repro_torch.compile datatype IR
# ---------------------------------------------------------------------------
# The exporters put the dense decode/prefill step onto the core Graph, so
# the compiler that builds resnet9 builds the LM: weights land as
# fake-quantized initializers (annotated with their FixedPointSpec), every
# matmul input passes through a FINN activation quantizer (multithreshold
# over the canonical grid table, which lower_to_integer_datapath
# streamlines to one ``quantize``), and the real-valued ops (rmsnorm, gelu,
# silu, softmax attention) stay float between quantizers.  The graphs are
# built from the same numpy values as the reference's: the same node names,
# ops, attrs and initializers.  ``decode_step_ref`` is the eager mirror of
# the decode graph, bit for bit with the compiled artifact.

def _decode_exportable(cfg: ArchConfig) -> None:
    """The exporter covers the plain dense family; fail loudly otherwise."""
    problems = []
    if cfg.family != "dense":
        problems.append(f"family={cfg.family!r} (need 'dense')")
    if cfg.attention != "gqa" or cfg.n_kv_heads != cfg.n_heads:
        problems.append("grouped/latent attention (need n_kv_heads==n_heads)")
    if cfg.pos != "none":
        problems.append(f"pos={cfg.pos!r} (rotary ids are not graph ops yet)")
    if cfg.qkv_bias or cfg.qk_norm:
        problems.append("qkv_bias/qk_norm")
    if cfg.moe_experts:
        problems.append("moe")
    if cfg.tie_embeddings:
        problems.append("tie_embeddings")
    if cfg.act not in ("gelu", "swiglu"):
        problems.append(f"act={cfg.act!r}")
    if problems:
        raise ValueError(
            f"config '{cfg.name}' is not decode-exportable: "
            + "; ".join(problems))


def _np(a):
    import numpy as np

    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def _block_params(params: Params, i: int):
    """Layer ``i``'s view of the stacked ``blocks`` tree, as numpy."""
    from repro_torch.tree import tree_map

    return tree_map(lambda a: _np(a[i]), params["blocks"])


def _export_graph(params: Params, cfg: ArchConfig, *, decode: bool,
                  name: Optional[str] = None):
    import numpy as np

    from repro_torch.core import quant
    from repro_torch.core.graph import Graph, Node

    _decode_exportable(cfg)
    wspec, aspec = _wspec(cfg), _aspec(cfg)
    H = cfg.n_heads
    nodes = []
    inits: Dict[str, Any] = {}
    dtypes: Dict[str, Any] = {}

    def w_init(nm, arr):
        w = np.asarray(_np(arr), np.float32)
        if wspec is not None:
            w = fake_quant(torch.from_numpy(np.ascontiguousarray(w)),
                           wspec).numpy()
        inits[nm] = w
        dtypes[nm] = wspec
        return nm

    def f_init(nm, arr):                 # float param (norm gains): no grid
        inits[nm] = np.asarray(_np(arr), np.float32)
        return nm

    def act_quant(x_t, out):
        """FINN activation quantizer: multithreshold over the canonical grid
        (exactly ``fake_quant(x, aspec)``).  Each node owns its table: the
        integer lowering rewrites int-fed tables in place."""
        if aspec is None:
            return x_t
        t_nm = f_init(out + "_t", quant.thresholds_for(aspec))
        nodes.append(Node("multithreshold", [x_t, t_nm], [out],
                          {"channel_axis": -1, "out_base": aspec.qmin,
                           "out_scale": aspec.scale}))
        return out

    def matmul(x_t, w_nm, out):
        nodes.append(Node("matmul", [x_t, w_nm], [out]))
        return out

    x = "x0"
    nodes.append(Node("embed", [w_init("embed_w", params["embed"]), "tokens"],
                      [x]))
    cache_in, cache_out = [], []
    for i in range(cfg.n_layers):
        bp = _block_params(params, i)
        p = f"l{i}"
        nodes.append(Node("rmsnorm", [x, f_init(f"{p}.ln1_g", bp["ln1"]["g"])],
                          [f"{p}.n1"], {"eps": cfg.norm_eps}))
        hq = act_quant(f"{p}.n1", f"{p}.aq1")
        q = matmul(hq, w_init(f"{p}.wq", bp["attn"]["wq"]["w"]), f"{p}.q")
        k = matmul(hq, w_init(f"{p}.wk", bp["attn"]["wk"]["w"]), f"{p}.k")
        v = matmul(hq, w_init(f"{p}.wv", bp["attn"]["wv"]["w"]), f"{p}.v")
        if decode:
            cache_in += [f"k{i}", f"v{i}"]
            cache_out += [f"k{i}_out", f"v{i}_out"]
            nodes.append(Node("attn_decode",
                              [q, k, v, f"k{i}", f"v{i}", "pos"],
                              [f"{p}.ao", f"k{i}_out", f"v{i}_out"],
                              {"heads": H}))
        else:
            cache_out += [k, v]          # prefill: the projections ARE the cache
            nodes.append(Node("attn_prefill", [q, k, v], [f"{p}.ao"],
                              {"heads": H}))
        aoq = act_quant(f"{p}.ao", f"{p}.aq2")
        matmul(aoq, w_init(f"{p}.wo", bp["attn"]["wo"]["w"]), f"{p}.o")
        nodes.append(Node("add", [x, f"{p}.o"], [f"{p}.r1"]))
        nodes.append(Node("rmsnorm",
                          [f"{p}.r1", f_init(f"{p}.ln2_g", bp["ln2"]["g"])],
                          [f"{p}.n2"], {"eps": cfg.norm_eps}))
        h2q = act_quant(f"{p}.n2", f"{p}.aq3")
        if cfg.act == "gelu":
            matmul(h2q, w_init(f"{p}.w_up", bp["mlp"]["w_up"]["w"]),
                   f"{p}.up")
            nodes.append(Node("gelu", [f"{p}.up"], [f"{p}.h"]))
        else:                            # swiglu
            matmul(h2q, w_init(f"{p}.w_gate", bp["mlp"]["w_gate"]["w"]),
                   f"{p}.gate")
            nodes.append(Node("silu", [f"{p}.gate"], [f"{p}.sg"]))
            matmul(h2q, w_init(f"{p}.w_up", bp["mlp"]["w_up"]["w"]),
                   f"{p}.up")
            nodes.append(Node("mul", [f"{p}.sg", f"{p}.up"], [f"{p}.h"]))
        hq2 = act_quant(f"{p}.h", f"{p}.aq4")   # mirrors L.mlp's mid-MLP QAT
        matmul(hq2, w_init(f"{p}.w_down", bp["mlp"]["w_down"]["w"]),
               f"{p}.dn")
        mq = act_quant(f"{p}.dn", f"{p}.aq5")   # mirrors _attn_block's output
        nodes.append(Node("add", [f"{p}.r1", mq], [f"{p}.r2"]))
        x = f"{p}.r2"
    nodes.append(Node("rmsnorm",
                      [x, f_init("final_g", params["final_norm"]["g"])],
                      ["nf"], {"eps": cfg.norm_eps}))
    fq = act_quant("nf", "head_aq")
    matmul(fq, w_init("lm_head_w", params["lm_head"]["w"]), "logits")
    inputs = ["tokens"] + (["pos"] + cache_in if decode else [])
    gname = name or (f"{cfg.name or 'lm'}-" + ("decode" if decode else
                                               "prefill"))
    g = Graph(nodes=nodes, inputs=inputs, outputs=["logits"] + cache_out,
              initializers=inits, name=gname)
    g.dtypes.update(dtypes)
    g.toposort()
    return g


def export_decode_graph(params: Params, cfg: ArchConfig, *,
                        name: Optional[str] = None):
    """One-token decode step as a core Graph.

    Inputs: ``tokens (B,) int32``, ``pos (B,) int32``, then per layer
    ``k{i}/v{i} (B, C, d_model) f32``: the capacity ``C`` is free, so one
    graph serves every KV bucket and the deploy layer captures one CUDA
    graph per (batch bucket x capacity).  Outputs: ``logits (B,
    vocab_padded)`` then the updated ``k{i}_out/v{i}_out`` caches.
    """
    return _export_graph(params, cfg, decode=True, name=name)


def export_prefill_graph(params: Params, cfg: ArchConfig, *,
                         name: Optional[str] = None):
    """Whole-prompt forward as a core Graph: ``tokens (B, S)`` ->
    ``logits (B, S, V)`` plus per-layer K/V projections ``(B, S, d_model)``
    (they ARE the prefill cache)."""
    return _export_graph(params, cfg, decode=False, name=name)


def decode_step_ref(params: Params, tokens, pos, caches, cfg: ArchConfig):
    """Eager float32 mirror of :func:`export_decode_graph`, bit for bit with
    the compiled artifact: the same helpers in the same order
    (``fake_quant`` == the graph's grid multithreshold == the int
    datapath's ``quantize``; ``rmsnorm``, ``gelu_tanh``, ``silu`` and
    ``ref.attn_decode`` are the graph executors' own functions).

    tokens/pos: (B,) int32; caches: [k0, v0, k1, v1, ...] each (B, C, D).
    Runs on the device of ``params``.  Returns ``(logits (B, V),
    new_caches)``.
    """
    from repro_torch.kernels import ref

    wspec, aspec = _wspec(cfg), _aspec(cfg)
    dev = params["embed"].device

    def fq_w(w):
        return fake_quant(w, wspec) if wspec is not None else w

    def aq(t):
        return fake_quant(t, aspec) if aspec is not None else t

    def mm(a, w):
        return ref._f32_matmul(a, fq_w(w))

    with torch.no_grad():
        tokens = torch.as_tensor(tokens, device=dev).long()
        pos = torch.as_tensor(pos, device=dev).to(torch.int32)
        caches = [torch.as_tensor(c, device=dev) for c in caches]
        x = fq_w(params["embed"]).to(torch.float32)[tokens]
        new_caches = []
        for i, bp in enumerate(_stacked_views(params["blocks"])):
            hq = aq(L.rmsnorm(bp["ln1"], x, cfg.norm_eps))
            q = mm(hq, bp["attn"]["wq"]["w"])
            k = mm(hq, bp["attn"]["wk"]["w"])
            v = mm(hq, bp["attn"]["wv"]["w"])
            o, kc, vc = ref.attn_decode(q, k, v, caches[2 * i],
                                        caches[2 * i + 1], pos, cfg.n_heads)
            new_caches += [kc, vc]
            x = x + mm(aq(o), bp["attn"]["wo"]["w"])
            h2q = aq(L.rmsnorm(bp["ln2"], x, cfg.norm_eps))
            if cfg.act == "gelu":
                h = L.gelu_tanh(mm(h2q, bp["mlp"]["w_up"]["w"]))
            else:
                h = (L.silu(mm(h2q, bp["mlp"]["w_gate"]["w"]))
                     * mm(h2q, bp["mlp"]["w_up"]["w"]))
            dn = mm(aq(h), bp["mlp"]["w_down"]["w"])
            x = x + aq(dn)
        fq = aq(L.rmsnorm(params["final_norm"], x, cfg.norm_eps))
        logits = mm(fq, params["lm_head"]["w"])
    return logits, new_caches


def example_decode_feeds(cfg: ArchConfig, *, batch: int = 2,
                         capacity: int = 8, seed: int = 0):
    """Named numpy feeds for :func:`export_decode_graph` golden-IO checks,
    drawn as the reference draws them."""
    import numpy as np

    rng = np.random.RandomState(seed)
    feeds = {
        "tokens": rng.randint(0, cfg.vocab, size=(batch,)).astype(np.int32),
        "pos": rng.randint(0, capacity, size=(batch,)).astype(np.int32),
    }
    for i in range(cfg.n_layers):
        feeds[f"k{i}"] = rng.randn(batch, capacity,
                                   cfg.d_model).astype(np.float32)
        feeds[f"v{i}"] = rng.randn(batch, capacity,
                                   cfg.d_model).astype(np.float32)
    return feeds


def example_prefill_feeds(cfg: ArchConfig, *, batch: int = 2, seq: int = 4,
                          seed: int = 0):
    import numpy as np

    rng = np.random.RandomState(seed)
    return {"tokens": rng.randint(0, cfg.vocab,
                                  size=(batch, seq)).astype(np.int32)}


@dataclasses.dataclass(frozen=True)
class DecodeHooks:
    """The decode workload's hook bundle (the recipe's
    ``workload_hooks("decode")``; FSL's is the other)."""

    export_decode: Any
    export_prefill: Any
    step_ref: Any
    example_feeds: Any


def _export_for_compile(model, qcfg):
    """``repro_torch.compile`` exporter: model = {"params", "cfg"}."""
    params, cfg = model["params"], model["cfg"]
    if qcfg is not None and qcfg is not cfg.quant:
        cfg = dataclasses.replace(cfg, quant=qcfg)
    return export_decode_graph(params, cfg)


def _register_recipe():
    from repro_torch.core.recipes import register_recipe

    register_recipe(
        "lm-decode",
        [],   # datatype passes ride in via compile(datapath="int"); no CNN
              # streamlining, and float attention is not HW-mappable
        description=("dense decoder-LM decode/prefill: datatype inference + "
                     "integer lowering only"),
        exporter=_export_for_compile,
        hooks={"decode": DecodeHooks(export_decode_graph,
                                     export_prefill_graph,
                                     decode_step_ref,
                                     example_decode_feeds)})


_register_recipe()
