"""Model building blocks of the LM: the PyTorch port of the JAX package's
``models/layers.py`` for the dense decoder family.

Params are plain dict trees of tensors, as in the reference.  Every linear
layer routes through :func:`dense`, which applies the paper's fixed-point
fake quantization to weights (QAT) or consumes serving codes: int8 (w8) or
packed int4 (w4) ``w_codes`` with a per-channel ``w_scale``.  On the card a
quantized ``dense`` runs the hand-written qmatmul kernel
(``csrc/qmatmul.cu``) through :func:`repro_torch.kernels.ops.qmatmul`.

The numerics follow the reference op for op: projections are bf16 whatever
the compute dtype (``dense`` casts to its ``dtype``, bf16 by default, and
the attention and MLP blocks never pass another), the bias is added in
bf16, RoPE rotates interleaved pairs ``x[..., 0::2]``/``x[..., 1::2]``,
and attention scores and softmax are float32.

Not in this slice of the port: chunked (flash-style) prefill attention,
cross-attention, M-RoPE, MLA, MoE and Mamba.  The branches that would
reach them raise ``NotImplementedError``.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch

from repro_torch.core.quant import FixedPointSpec, fake_quant, pack_int4
from repro_torch.kernels import ops

Params = Dict[str, torch.Tensor]


def not_ported(what: str, slice_: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported yet: it waits for the {slice_} slice of the "
        "PyTorch port (repro_torch builds the dense LM family so far)")


def _uniform(gen: torch.Generator, shape, lo: float, hi: float,
             device: torch.device) -> torch.Tensor:
    u = torch.rand(shape, generator=gen, dtype=torch.float32,
                   device=gen.device)
    return u.mul_(hi - lo).add_(lo).to(device)


# ---------------------------------------------------------------------------
# Quant-aware dense
# ---------------------------------------------------------------------------
def dense_init(gen: torch.Generator, d_in: int, d_out: int,
               bias: bool = False, stack: Tuple[int, ...] = (),
               device: torch.device = torch.device("cpu")) -> Params:
    """Uniform(-1/sqrt(d_in), 1/sqrt(d_in)) weights, zero bias, drawn from
    ``gen`` on its own device and moved to ``device``."""
    scale = 1.0 / math.sqrt(d_in)
    p = {"w": _uniform(gen, (*stack, d_in, d_out), -scale, scale, device)}
    if bias:
        p["b"] = torch.zeros((*stack, d_out), dtype=torch.float32,
                             device=device)
    return p


def quantize_dense_for_serving(p: Params, bits: int) -> Params:
    """fp weights -> {w_codes, w_scale} for the w8/w4 decode path.

    Per-output-channel symmetric scales, as the reference: ``amax`` over
    the input axis (-2, which keeps a stacked layer axis), ``scale =
    max(amax / qmax, 1e-12)``, ``codes = clip(round(w / scale))`` with a
    division and round-half-even, so codes and scales equal the JAX
    package's bit for bit.  w4 codes are packed two to a byte.
    """
    w = p["w"]
    qmax = 2 ** (bits - 1) - 1
    amax = torch.amax(torch.abs(w), dim=-2, keepdim=True)   # (..., 1, N)
    # a true division on every device: CUDA divides by a Python scalar as a
    # multiply by its reciprocal, one bit off the reference's quotient
    qmax_t = torch.full((), float(qmax), dtype=amax.dtype, device=amax.device)
    scale = torch.clamp_min(amax / qmax_t, 1e-12)
    codes = torch.div(w, scale).round_().clamp_(-qmax - 1, qmax)
    if bits == 4:
        codes = pack_int4(codes.to(torch.int32))             # (..., K, N//2)
    else:
        codes = codes.to(torch.int8)
    out = {"w_codes": codes,
           "w_scale": scale[..., 0, :].to(torch.float32).contiguous()}
    if "b" in p:
        out["b"] = p["b"]
    return out


def dense(p: Params, x: torch.Tensor, wspec: Optional[FixedPointSpec] = None,
          dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """y = x @ W (+ b).  Three weight datapaths:

    * fp / QAT: ``W`` fake-quantized to the paper's grid when ``wspec``;
      ``torch.matmul`` in ``dtype``, as the reference leaves it to XLA.
    * w8 codes: int8 ``w_codes`` x float32 per-channel ``w_scale`` through
      :func:`ops.qmatmul` (the qmatmul kernel on the card): bf16 x, float32
      accumulation, the scale applied to the accumulator, bf16 out.
    * w4 codes: packed int4 codes, the same path (unpacked in the kernel's
      tile load).
    """
    if "w_codes" in p:
        codes, scale = p["w_codes"], p["w_scale"]
        if dtype != torch.bfloat16:
            # the reference's float32 contraction of codes (an untied,
            # quantized LM head) is not qmatmul's function
            raise not_ported(f"a quantized dense in {dtype}", "untied-head")
        bits = 4 if codes.shape[-1] != scale.shape[-1] else 8
        y = ops.qmatmul(x.to(torch.bfloat16), codes, scale, bits)
    else:
        w = fake_quant(p["w"], wspec) if wspec is not None else p["w"]
        y = torch.matmul(x.to(dtype), w.to(dtype))
    if "b" in p:
        y = y + p["b"].to(y.dtype)
    return y


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------
def rmsnorm_init(d: int, stack: Tuple[int, ...] = (),
                 device: torch.device = torch.device("cpu")) -> Params:
    return {"g": torch.ones((*stack, d), dtype=torch.float32, device=device)}


def rmsnorm(p: Params, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    xf = x.to(torch.float32)
    y = xf * torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
    return (y * p["g"]).to(x.dtype)


# ---------------------------------------------------------------------------
# Rotary embeddings
# ---------------------------------------------------------------------------
def _rope_freqs(hd: int, theta: float, device: torch.device) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, hd, 2, dtype=torch.float32,
                                         device=device) / hd))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (B, S, H, hd); positions: (B, S) integer.  Rotates interleaved
    pairs (x[..., 0::2], x[..., 1::2]), as the reference."""
    hd = x.shape[-1]
    ang = positions[..., None].to(torch.float32) * _rope_freqs(hd, theta,
                                                               x.device)
    cos, sin = torch.cos(ang)[:, :, None, :], torch.sin(ang)[:, :, None, :]
    x1, x2 = x[..., 0::2], x[..., 1::2]
    out = torch.stack([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.reshape(x.shape).to(x.dtype)


# ---------------------------------------------------------------------------
# Attention (GQA + KV cache)
# ---------------------------------------------------------------------------
def attn_init(gen: torch.Generator, cfg, stack: Tuple[int, ...] = (),
              device: torch.device = torch.device("cpu"),
              d_model: Optional[int] = None) -> Params:
    d = d_model or cfg.d_model
    hd, H, KV = cfg.hd, cfg.n_heads, cfg.n_kv_heads
    kw = dict(stack=stack, device=device)
    p = {"wq": dense_init(gen, d, H * hd, bias=cfg.qkv_bias, **kw),
         "wk": dense_init(gen, d, KV * hd, bias=cfg.qkv_bias, **kw),
         "wv": dense_init(gen, d, KV * hd, bias=cfg.qkv_bias, **kw),
         "wo": dense_init(gen, H * hd, d, **kw)}
    if cfg.qk_norm:
        p["q_norm"] = rmsnorm_init(hd, **kw)
        p["k_norm"] = rmsnorm_init(hd, **kw)
    return p


def _gqa_scores(q: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """q (B, Sq, H, hd), k (B, Sk, KV, hd) -> float32 (B, KV, rep, Sq, Sk)
    scores over sqrt(hd), each query head against its KV group."""
    B, Sq, H, hd = q.shape
    KV = k.shape[2]
    qh = q.reshape(B, Sq, KV, H // KV, hd)
    return torch.einsum("bqgrh,bkgh->bgrqk", qh.to(torch.float32),
                        k.to(torch.float32)) / math.sqrt(hd)


def _gqa_mix(w: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Softmax weights (B, KV, rep, Sq, Sk) x v (B, Sk, KV, hd) ->
    float32 (B, Sq, H, hd)."""
    out = torch.einsum("bgrqk,bkgh->bqgrh", w, v.to(torch.float32))
    B, Sq, KV, rep, hd = out.shape
    return out.reshape(B, Sq, KV * rep, hd)


def _sdpa(q, k, v, causal: bool, q_offset: int = 0) -> torch.Tensor:
    """Plain attention: q (B,Sq,H,hd), k/v (B,Sk,KV,hd).  GQA broadcast."""
    scores = _gqa_scores(q, k)
    if causal:
        iq = torch.arange(q.shape[1], device=q.device) + q_offset
        ik = torch.arange(k.shape[1], device=q.device)
        scores = scores.masked_fill(ik[None, :] > iq[:, None], -math.inf)
    w = torch.softmax(scores, dim=-1)
    return _gqa_mix(w, v).to(q.dtype)


def attention(p: Params, x: torch.Tensor, cfg, positions: torch.Tensor, *,
              cache: Optional[Params] = None, causal: bool = True,
              kv_source: Optional[torch.Tensor] = None,
              wspec: Optional[FixedPointSpec] = None
              ) -> Tuple[torch.Tensor, Optional[Params]]:
    """GQA self-attention.  Modes:

    * train/prefill: ``cache`` is None (full sequence); returns (out, None);
    * prefill with a cache dict: fills the cache, returns (out, cache);
    * decode: x is (B, 1, d); the cache holds k, v (B, Smax, KV, hd) and a
      0-d ``len``; positions at ``len`` and beyond are masked.

    The cache's ``k`` and ``v`` are written in place at ``len`` (the
    reference's jitted step donates them), and the returned cache holds the
    same tensors with ``len + S``.
    """
    if kv_source is not None or (cache is not None and "len" not in cache):
        raise not_ported("cross-attention", "encoder-decoder (whisper)")
    B, S, _ = x.shape
    hd, H, KV = cfg.hd, cfg.n_heads, cfg.n_kv_heads
    q = dense(p["wq"], x, wspec).reshape(B, S, H, hd)
    k = dense(p["wk"], x, wspec).reshape(B, S, KV, hd)
    v = dense(p["wv"], x, wspec).reshape(B, S, KV, hd)
    if "q_norm" in p:
        q = rmsnorm(p["q_norm"], q)
        k = rmsnorm(p["k_norm"], k)
    if cfg.pos == "rope":
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    elif cfg.pos == "mrope":
        raise not_ported("M-RoPE", "vision-language (qwen2-vl)")

    new_cache = None
    if cache is not None:
        idx = cache["len"]
        rows = idx.to(torch.int64) + torch.arange(S, device=x.device)
        cache["k"].index_copy_(1, rows, k.to(cache["k"].dtype))
        cache["v"].index_copy_(1, rows, v.to(cache["v"].dtype))
        new_cache = {"k": cache["k"], "v": cache["v"], "len": idx + S}
        k, v = cache["k"], cache["v"]
        if S == 1:
            # decode: mask positions beyond the current length
            valid = torch.arange(k.shape[1], device=x.device) < (idx + 1)
            scores = _gqa_scores(q, k).masked_fill(~valid, -math.inf)
            w = torch.softmax(scores, dim=-1)
            out = _gqa_mix(w, v).to(x.dtype)
            return dense(p["wo"], out.reshape(B, 1, H * hd), wspec), new_cache

    if causal and S > 2 * cfg.prefill_chunk and S % cfg.prefill_chunk == 0:
        raise not_ported(f"chunked (flash-style) prefill attention at "
                          f"S={S} > 2 x prefill_chunk", "long-prefill")
    out = _sdpa(q, k, v, causal=causal)
    return dense(p["wo"], out.reshape(B, S, H * hd), wspec), new_cache


# ---------------------------------------------------------------------------
# MLPs
# ---------------------------------------------------------------------------
def mlp_init(gen: torch.Generator, d: int, f: int, act: str = "swiglu",
             stack: Tuple[int, ...] = (),
             device: torch.device = torch.device("cpu")) -> Params:
    kw = dict(stack=stack, device=device)
    if act == "swiglu":
        return {"w_gate": dense_init(gen, d, f, **kw),
                "w_up": dense_init(gen, d, f, **kw),
                "w_down": dense_init(gen, f, d, **kw)}
    return {"w_up": dense_init(gen, d, f, **kw),
            "w_down": dense_init(gen, f, d, **kw)}


def _const(v: float, like: torch.Tensor) -> torch.Tensor:
    """``v`` rounded to ``like``'s dtype, on its device.  A fill, not a copy
    from the host, so it may run inside a CUDA graph capture."""
    return torch.full((), v, dtype=like.dtype, device=like.device)


def _logistic(x: torch.Tensor) -> torch.Tensor:
    return 1 / (1 + torch.exp(-x))


class _Silu(torch.autograd.Function):
    """silu whose backward is ``jax.grad``'s, op for op in x's dtype: the
    cotangent ``ct * t + (x * ct) * (t * (1 - t))``, ``t`` the logistic
    (JAX's logistic derivative ``ans * (1 - ans)``).  Autograd through
    the forward's ops would round other intermediates in bf16."""

    @staticmethod
    def forward(ctx, x):
        t = _logistic(x)
        ctx.save_for_backward(x, t)
        return x * t

    @staticmethod
    def backward(ctx, ct):
        x, t = ctx.saved_tensors
        return ct * t + (x * ct) * (t * (1 - t))


def silu(x: torch.Tensor) -> torch.Tensor:
    """``x * sigmoid(x)`` as the reference's ``jax.nn.silu`` evaluates in
    x's dtype: the logistic expands to ``1 / (1 + exp(-x))`` with every op
    rounded to that dtype (bf16 for the projections), which
    ``torch.sigmoid``'s single rounding would not reproduce.  Its gradient
    is the reference's too (:class:`_Silu`)."""
    return _Silu.apply(x)


def _gelu_consts(x: torch.Tensor):
    return _const(math.sqrt(2 / math.pi), x), _const(0.044715, x)


class _GeluTanh(torch.autograd.Function):
    """gelu (tanh form) whose backward is ``jax.grad``'s of
    ``x * 0.5 * (1 + tanh(s * (x + k * x**3)))``, op for op in x's dtype:
    tanh's derivative as JAX writes it, ``(g + g * ans) * (1 - ans)``,
    ``x**3``'s as ``3 * x**2``, and x's three cotangents summed in the
    order JAX's backward pass adds them."""

    @staticmethod
    def forward(ctx, x):
        s, k = _gelu_consts(x)
        th = torch.tanh(s * (x + k * (x * x * x)))
        cdf = 0.5 * (1.0 + th)
        ctx.save_for_backward(x, th, cdf)
        return x * cdf

    @staticmethod
    def backward(ctx, ct):
        x, th, cdf = ctx.saved_tensors
        s, k = _gelu_consts(x)
        g = (0.5 * (x * ct)) * (1 - th)
        ct_u = s * (g + g * th)
        return (ct * cdf + ct_u) + (k * ct_u) * (3 * (x * x))


def gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu`` (tanh form, its default) op for op in x's dtype,
    constants rounded to that dtype first as JAX's weak types are; its
    gradient is the reference's too (:class:`_GeluTanh`)."""
    return _GeluTanh.apply(x)


def mlp(p: Params, x: torch.Tensor, act: str = "swiglu", wspec=None,
        aspec=None) -> torch.Tensor:
    if act == "swiglu":
        h = silu(dense(p["w_gate"], x, wspec)) * dense(p["w_up"], x, wspec)
    else:
        h = gelu_tanh(dense(p["w_up"], x, wspec))
    h = fake_quant(h, aspec)
    return dense(p["w_down"], h, wspec)
