"""Whisper-style encoder-decoder backbone (audio frontend stubbed): the
PyTorch port of the JAX package's ``models/whisper.py``.

As in the reference, the conv frame frontend is a stub: the encoder takes
precomputed frame embeddings (B, enc_seq, d_model).  The backbone is a
pre-LN encoder (bidirectional self-attention) and a decoder (causal
self-attention, cross-attention to the encoder's output, gelu MLPs), with
learned positions and a head tied to the embedding, every projection
through :func:`repro_torch.models.layers.dense` (``qmatmul`` on serving
codes).

Entry points, as the reference's: ``init_params``, ``encode``, ``decode``,
``forward``, ``loss_fn``, ``prefill``, ``init_cache``,
``build_cross_cache`` and ``decode_step``.  The decode cache holds the
self-attention k/v with a length (``self``) and the cross-attention k/v
precomputed from the encoder's output (``cross``, no length).  A decode
step reads its learned position at the self cache's length on the device,
clamped to the table as ``jax.lax.dynamic_slice_in_dim`` clamps, so a
captured CUDA graph replays it.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import layers as L
from repro_torch.models.common import ArchConfig
from repro_torch.models.lm import (_aspec, _gold, _lookup, _stacked_views,
                                   _tied_logits, _wspec, compute_dtype,
                                   with_head_copy)

__all__ = ["init_params", "encode", "decode", "forward", "loss_fn",
           "prefill", "init_cache", "build_cross_cache", "decode_step",
           "compute_dtype", "with_head_copy"]

Params = Dict[str, Any]


def _enc_block_init(gen, cfg, stack, dev) -> Params:
    return {"ln1": L.layernorm_init(cfg.d_model, stack, dev),
            "attn": L.attn_init(gen, cfg, stack, dev),
            "ln2": L.layernorm_init(cfg.d_model, stack, dev),
            "mlp": L.mlp_init(gen, cfg.d_model, cfg.d_ff, "gelu", stack,
                              dev)}


def _dec_block_init(gen, cfg, stack, dev) -> Params:
    return {"ln1": L.layernorm_init(cfg.d_model, stack, dev),
            "self_attn": L.attn_init(gen, cfg, stack, dev),
            "ln_x": L.layernorm_init(cfg.d_model, stack, dev),
            "cross_attn": L.attn_init(gen, cfg, stack, dev),
            "ln2": L.layernorm_init(cfg.d_model, stack, dev),
            "mlp": L.mlp_init(gen, cfg.d_model, cfg.d_ff, "gelu", stack,
                              dev)}


def init_params(gen: torch.Generator, cfg: ArchConfig,
                device: DeviceLike = None) -> Params:
    """Embedding N(0, 0.02), learned positions N(0, 0.01) (``pos_dec``
    ``max_seq`` rows, ``pos_enc`` ``enc_seq`` rows), LayerNorm gains 1 and
    biases 0, dense weights uniform in ±1/sqrt(d_in): the reference's
    distributions, drawn from ``gen`` on its own device and moved to
    ``device`` (default: the card)."""
    dev = resolve_device(device)
    d = cfg.d_model

    def normal(rows, std):
        t = torch.randn((rows, d), generator=gen, dtype=torch.float32,
                        device=gen.device)
        return t.mul_(std).to(dev)

    return {"embed": normal(cfg.vocab_padded, 0.02),
            "pos_dec": normal(cfg.max_seq, 0.01),
            "pos_enc": normal(cfg.enc_seq, 0.01),
            "enc_blocks": _enc_block_init(gen, cfg, (cfg.enc_layers,), dev),
            "dec_blocks": _dec_block_init(gen, cfg, (cfg.n_layers,), dev),
            "enc_ln": L.layernorm_init(d, device=dev),
            "dec_ln": L.layernorm_init(d, device=dev)}


def encode(params: Params, frames: torch.Tensor,
           cfg: ArchConfig) -> torch.Tensor:
    """frames: (B, S <= enc_seq, d) precomputed embeddings (the frontend
    stub) -> the encoder's output (B, S, d) in the compute dtype."""
    ws, as_ = _wspec(cfg), _aspec(cfg)
    cd = compute_dtype(cfg)
    B, S, _ = frames.shape
    x = frames.to(cd) + params["pos_enc"][None, :S].to(cd)
    positions = torch.arange(S, dtype=torch.int32,
                             device=x.device)[None].expand(B, S)
    for bp in _stacked_views(params["enc_blocks"]):
        h = L.layernorm(bp["ln1"], x)
        a, _ = L.attention(bp["attn"], h, cfg, positions, causal=False,
                           wspec=ws)
        x = x + a
        h = L.layernorm(bp["ln2"], x)
        x = x + L.mlp(bp["mlp"], h, "gelu", ws, as_)
    return L.layernorm(params["enc_ln"], x)


def _dec_block(bp: Params, x: torch.Tensor, enc_out, cfg: ArchConfig,
               positions: torch.Tensor, cache: Optional[Params] = None):
    """Causal self-attention, cross-attention (to ``enc_out``, or with a
    cache to its precomputed ``cross`` k/v), gelu MLP; returns (output,
    the new cache or None)."""
    ws, as_ = _wspec(cfg), _aspec(cfg)
    h = L.layernorm(bp["ln1"], x)
    a, new_self = L.attention(bp["self_attn"], h, cfg, positions,
                              cache=None if cache is None else cache["self"],
                              wspec=ws)
    x = x + a
    h = L.layernorm(bp["ln_x"], x)
    a, _ = L.attention(bp["cross_attn"], h, cfg, positions, causal=False,
                       kv_source=enc_out,
                       cache=None if cache is None else cache["cross"],
                       wspec=ws)
    x = x + a
    h = L.layernorm(bp["ln2"], x)
    x = x + L.mlp(bp["mlp"], h, "gelu", ws, as_)
    if cache is None:
        return x, None
    return x, {"self": cache["self"] if new_self is None else new_self,
               "cross": cache["cross"]}


def _head(params: Params, x: torch.Tensor) -> torch.Tensor:
    """The decoder's final LayerNorm, then the tied head: the embedding
    table in the compute dtype (``embed_head`` where
    :func:`with_head_copy` made one)."""
    x = L.layernorm(params["dec_ln"], x)
    w = params.get("embed_head")
    if w is None or w.dtype != x.dtype:
        w = params["embed"].to(x.dtype)
    return _tied_logits(x, w)


def decode(params: Params, tokens: torch.Tensor, enc_out: torch.Tensor,
           cfg: ArchConfig, position_offset: int = 0) -> torch.Tensor:
    """Every position's logits (B, S, vocab_padded) of ``tokens`` (B, S)
    at positions ``position_offset`` on, against the encoder output.  The
    learned positions start at the offset clamped to the table, as
    ``jax.lax.dynamic_slice_in_dim`` clamps it."""
    cd = compute_dtype(cfg)
    B, S = tokens.shape
    x = _lookup(params["embed"], tokens).to(cd)
    start = min(max(int(position_offset), 0), params["pos_dec"].shape[0] - S)
    x = x + params["pos_dec"][start:start + S].to(cd)[None]
    positions = (torch.arange(S, dtype=torch.int32, device=x.device)[None]
                 + position_offset).expand(B, S)
    for bp in _stacked_views(params["dec_blocks"]):
        x, _ = _dec_block(bp, x, enc_out, cfg, positions)
    return _head(params, x)


def forward(params: Params, batch: Dict[str, torch.Tensor],
            cfg: ArchConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """(logits of every decoder position, a zero aux loss)."""
    logits = decode(params, batch["tokens"],
                    encode(params, batch["frames"], cfg), cfg)
    return logits, torch.zeros((), dtype=torch.float32,
                               device=logits.device)


def loss_fn(params: Params, batch: Dict[str, torch.Tensor],
            cfg: ArchConfig) -> torch.Tensor:
    """Mean token cross-entropy in float32 over all ``vocab_padded``
    logits, as the reference (no aux term).  A serving head copy
    (``embed_head``) is ignored, as in ``lm.loss_fn``."""
    params = {k: v for k, v in params.items() if k != "embed_head"}
    lf = forward(params, batch, cfg)[0].to(torch.float32)
    gold = _gold(lf, batch["labels"])
    return (torch.logsumexp(lf, dim=-1) - gold).mean()


def prefill(params: Params, batch: Dict[str, torch.Tensor],
            cfg: ArchConfig) -> torch.Tensor:
    """Encoder and the full decoder pass, last-position logits (B, V)."""
    return forward(params, batch, cfg)[0][:, -1]


def init_cache(cfg: ArchConfig, B: int, max_len: int,
               dtype: torch.dtype = torch.bfloat16,
               device: DeviceLike = None) -> Params:
    """``self``: k, v (n_layers, B, max_len, KV, hd) and per-layer int32
    lengths; ``cross``: k, v (n_layers, B, enc_seq, KV, hd), zero until
    :func:`build_cross_cache`'s values are copied in."""
    dev = resolve_device(device)
    hd, KV, n = cfg.hd, cfg.n_kv_heads, cfg.n_layers

    def zeros(*shape):
        return torch.zeros(shape, dtype=dtype, device=dev)

    return {"self": {"k": zeros(n, B, max_len, KV, hd),
                     "v": zeros(n, B, max_len, KV, hd),
                     "len": torch.zeros((n,), dtype=torch.int32,
                                        device=dev)},
            "cross": {"k": zeros(n, B, cfg.enc_seq, KV, hd),
                      "v": zeros(n, B, cfg.enc_seq, KV, hd)}}


def build_cross_cache(params: Params, enc_out: torch.Tensor,
                      cfg: ArchConfig,
                      dtype: torch.dtype = torch.bfloat16) -> Params:
    """Every decoder layer's cross-attention k and v of the encoder output
    (B, Se, d): {"k", "v"} (n_layers, B, Se, KV, hd) in ``dtype``."""
    ws = _wspec(cfg)
    B, Se, _ = enc_out.shape
    ks, vs = [], []
    for bp in _stacked_views(params["dec_blocks"]):
        for name, out in (("wk", ks), ("wv", vs)):
            t = L.dense(bp["cross_attn"][name], enc_out, ws)
            out.append(t.reshape(B, Se, cfg.n_kv_heads, cfg.hd).to(dtype))
    return {"k": torch.stack(ks), "v": torch.stack(vs)}


def decode_step(params: Params, tokens: torch.Tensor, cache: Params,
                cfg: ArchConfig) -> Tuple[torch.Tensor, Params]:
    """One decoder token (B, 1) against the cached self k/v and the
    precomputed cross k/v -> logits (B, V).  The self cache's rows are
    written in place; the returned cache holds the same tensors with the
    lengths advanced (new length tensors) and the same ``cross``."""
    cd = compute_dtype(cfg)
    B, T = tokens.shape
    sc, cc = cache["self"], cache["cross"]
    idx = sc["len"][0]
    row = idx.clamp(0, params["pos_dec"].shape[0] - 1).reshape(1)
    x = _lookup(params["embed"], tokens).to(cd) \
        + params["pos_dec"].index_select(0, row).to(cd)[None]
    positions = idx.expand(B, 1)
    for i, bp in enumerate(_stacked_views(params["dec_blocks"])):
        x, _ = _dec_block(bp, x, None, cfg, positions, cache={
            "self": {"k": sc["k"][i], "v": sc["v"][i], "len": sc["len"][i]},
            "cross": {"k": cc["k"][i], "v": cc["v"][i]}})
    new_cache = {"self": dict(sc, len=sc["len"] + T), "cross": cc}
    return _head(params, x)[:, 0], new_cache
