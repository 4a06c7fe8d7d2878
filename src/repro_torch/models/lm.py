"""Decoder LM of the dense family: the PyTorch port of the JAX package's
``models/lm.py`` (its dense path).

Entry points (functions of (params, batch), as in the reference):

* ``init_params(gen, cfg, device)`` — parameter tree with stacked
  ``(n_layers, ...)`` block leaves, the reference's layout, so a JAX tree
  carried across with :func:`repro_torch.convert.params_from_numpy` runs
  unchanged.  The reference scans over the stacked leaves; the port loops
  over layers in Python.
* ``forward(params, batch, cfg)`` — full-sequence logits (and a zero aux
  loss, the reference's MoE slot).
* ``prefill(params, batch, cfg)`` — last-position logits only.
* ``init_cache(cfg, B, max_len, dtype, device)`` — the KV cache.
* ``decode_step(params, tokens, cache, cfg)`` — one new token for every
  sequence; the cache's k/v are written in place.

MoE, MLA, SSM, hybrid, VLM and audio families wait for later slices of the
port and raise ``NotImplementedError``.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch

from repro_torch.core.quant import fake_quant
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import layers as L
from repro_torch.models.common import ArchConfig

Params = Dict[str, Any]


def _wspec(cfg: ArchConfig):
    return cfg.quant.weight if cfg.quant else None


def _aspec(cfg: ArchConfig):
    return cfg.quant.act if cfg.quant else None


def compute_dtype(cfg: ArchConfig) -> torch.dtype:
    return getattr(torch, cfg.compute_dtype)


def _require_dense(cfg: ArchConfig) -> None:
    if cfg.family != "dense":
        raise L.not_ported(f"the {cfg.family} family", cfg.family)
    if cfg.attention == "mla":
        raise L.not_ported("MLA attention", "MLA (minicpm3)")
    if cfg.moe_experts:
        raise L.not_ported("MoE layers", "moe")


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------
def init_params(gen: torch.Generator, cfg: ArchConfig,
                device: DeviceLike = None) -> Params:
    """Embedding N(0, 0.02), RMSNorm gains 1, dense weights uniform in
    ±1/sqrt(d_in), zero biases: the reference's distributions.  The draws
    come from ``gen`` on its own device (a CUDA generator draws the full
    model on the card), then move to ``device`` (default: the card)."""
    _require_dense(cfg)
    dev = resolve_device(device)
    n, d = cfg.n_layers, cfg.d_model
    embed = torch.randn((cfg.vocab_padded, d), generator=gen,
                        dtype=torch.float32, device=gen.device)
    p: Params = {"embed": embed.mul_(0.02).to(dev),
                 "final_norm": L.rmsnorm_init(d, device=dev)}
    if not cfg.tie_embeddings:
        p["lm_head"] = L.dense_init(gen, d, cfg.vocab_padded, device=dev)
    stack = (n,)
    p["blocks"] = {
        "ln1": L.rmsnorm_init(d, stack, dev),
        "ln2": L.rmsnorm_init(d, stack, dev),
        "attn": L.attn_init(gen, cfg, stack, dev),
        "mlp": L.mlp_init(gen, d, cfg.d_ff, cfg.act, stack, dev),
    }
    return p


def _layer(blocks: Params, i: int) -> Params:
    """Layer ``i``'s tree: a view of every stacked leaf at index i."""
    if isinstance(blocks, dict):
        return {k: _layer(v, i) for k, v in blocks.items()}
    return blocks[i]


def _layers(params: Params, cfg: ArchConfig) -> List[Params]:
    return [_layer(params["blocks"], i) for i in range(cfg.n_layers)]


# ---------------------------------------------------------------------------
# Blocks, embedding, head
# ---------------------------------------------------------------------------
def _attn_block(p: Params, x: torch.Tensor, cfg: ArchConfig,
                positions: torch.Tensor, cache=None):
    ws, as_ = _wspec(cfg), _aspec(cfg)
    h = L.rmsnorm(p["ln1"], x, cfg.norm_eps)
    a, new_cache = L.attention(p["attn"], h, cfg, positions, cache=cache,
                               wspec=ws)
    x = x + a
    h = L.rmsnorm(p["ln2"], x, cfg.norm_eps)
    m = L.mlp(p["mlp"], h, cfg.act, ws, as_)
    return x + fake_quant(m, as_), new_cache


def _embed_tokens(p: Params, tokens: torch.Tensor,
                  cfg: ArchConfig) -> torch.Tensor:
    return p["embed"][tokens].to(compute_dtype(cfg))


def _positions_for(batch, S: int, B: int, device) -> torch.Tensor:
    if "positions" in batch:
        return batch["positions"]
    return torch.arange(S, dtype=torch.int32, device=device)[None].expand(B, S)


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
        return torch.matmul(x, w.T)
    return L.dense(p["lm_head"], x, _wspec(cfg), dtype=x.dtype)


# ---------------------------------------------------------------------------
# Forward, prefill
# ---------------------------------------------------------------------------
def _trunk(params: Params, batch: Dict[str, torch.Tensor],
           cfg: ArchConfig) -> torch.Tensor:
    _require_dense(cfg)
    x = _embed_tokens(params, batch["tokens"], cfg)
    B, S, _ = x.shape
    positions = _positions_for(batch, S, B, x.device)
    for bp in _layers(params, cfg):
        x, _ = _attn_block(bp, x, cfg, positions)
    return x


def forward(params: Params, batch: Dict[str, torch.Tensor], cfg: ArchConfig
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (logits, aux loss); aux is the reference's MoE slot, zero for
    the dense family."""
    x = L.rmsnorm(params["final_norm"], _trunk(params, batch, cfg),
                  cfg.norm_eps)
    return _head(params, x, cfg), torch.zeros((), dtype=torch.float32,
                                              device=x.device)


def prefill(params: Params, batch: Dict[str, torch.Tensor], cfg: ArchConfig
            ) -> torch.Tensor:
    """Full-sequence forward; emits ONLY last-position logits (B, V)."""
    x = _trunk(params, batch, cfg)
    x = L.rmsnorm(params["final_norm"], x[:, -1:], cfg.norm_eps)
    return _head(params, x, cfg)[:, 0]


# ---------------------------------------------------------------------------
# Decode
# ---------------------------------------------------------------------------
def init_cache(cfg: ArchConfig, B: int, max_len: int,
               dtype: torch.dtype = torch.bfloat16,
               device: DeviceLike = None) -> Params:
    """KV cache with a leading layer axis: k, v (n_layers, B, max_len, KV,
    hd) and per-layer int32 lengths."""
    _require_dense(cfg)
    dev = resolve_device(device)
    shape = (cfg.n_layers, B, max_len, cfg.n_kv_heads, cfg.hd)
    return {"attn": {"k": torch.zeros(shape, dtype=dtype, device=dev),
                     "v": torch.zeros(shape, dtype=dtype, device=dev),
                     "len": torch.zeros((cfg.n_layers,), dtype=torch.int32,
                                        device=dev)}}


def decode_step(params: Params, tokens: torch.Tensor, cache: Params,
                cfg: ArchConfig, positions: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, Params]:
    """One new token for every sequence: tokens (B, 1) -> logits (B, V).

    Positions come from the first layer's cache length, kept on the device
    (no host sync per step).  The cache's k/v are updated in place and the
    returned cache holds them with every length advanced by the new
    tokens.
    """
    _require_dense(cfg)
    B = tokens.shape[0]
    x = _embed_tokens(params, tokens, cfg)
    c = cache["attn"]
    if positions is None:
        positions = c["len"][0].expand(B, 1)
    for i, bp in enumerate(_layers(params, cfg)):
        lc = {"k": c["k"][i], "v": c["v"][i], "len": c["len"][i]}
        x, _ = _attn_block(bp, x, cfg, positions, cache=lc)
    new_cache = dict(cache)
    new_cache["attn"] = {"k": c["k"], "v": c["v"],
                         "len": c["len"] + tokens.shape[1]}
    x = L.rmsnorm(params["final_norm"], x, cfg.norm_eps)
    return _head(params, x, cfg)[:, 0], new_cache
