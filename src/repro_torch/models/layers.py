"""Model building blocks of the LMs: the PyTorch port of the JAX package's
``models/layers.py`` for every family (dense, MLA, MoE, vision-language,
SSM, hybrid, and the audio encoder-decoder's LayerNorm and
cross-attention).

Params are plain dict trees of tensors, as in the reference.  Every linear
layer routes through :func:`dense`, which applies the paper's fixed-point
fake quantization to weights (QAT) or consumes serving codes: int8 (w8) or
packed int4 (w4) ``w_codes`` with a per-channel ``w_scale``.  On the card a
quantized ``dense`` runs the hand-written qmatmul kernel
(``csrc/qmatmul.cu``) through :func:`repro_torch.kernels.ops.qmatmul`.

The numerics follow the reference op for op: projections are bf16 whatever
the compute dtype (``dense`` casts to its ``dtype``, bf16 by default, and
the attention and MLP blocks never pass another), the bias is added in
bf16, RoPE and M-RoPE rotate interleaved pairs ``x[..., 0::2]``/``x[...,
1::2]``, and attention scores and softmax are float32.  A decode step
writes its cache in place: the k/v rows at ``len``, MLA's latent and
rope-key rows, and Mamba2's conv and SSM state (the reference's jitted
step donates them), so one captured CUDA graph replays the step.

Serving codes reach two functions that the reference cannot run on them
(its ``moe`` and ``mla_attention`` fail on the tree its own
``quantize_tree_for_serving`` makes): an expert bank of codes runs each
expert's products through :func:`dense` (``qmatmul`` in bf16), and MLA's
``wkv_b`` is dequantized for its two einsums.
"""

from __future__ import annotations

import functools
import math
from typing import Dict, List, Optional, Tuple

import torch

from repro_torch.core.quant import (FixedPointSpec, fake_quant, pack_int4,
                                    unpack_int4)
from repro_torch.dist import dtensor as D
from repro_torch.dist.act_sharding import constrain
from repro_torch.dist.sharding import moe_expert_axis
from repro_torch.kernels import ops

Params = Dict[str, torch.Tensor]


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

    Codes in another ``dtype`` (the untied head of a float32 model) take
    the reference's plain contraction: x and the codes in ``dtype``, a
    float32 product (``torch.matmul``), times the scale.  That is not
    qmatmul's function (bf16 x), and the reference leaves it to XLA too.
    """
    if "w_codes" in p:
        codes, scale = p["w_codes"], p["w_scale"]
        # from the global shapes: a rank's codes hold only its columns
        bits = 4 if codes.shape[-1] != scale.shape[-1] else 8

        def product(x, codes, scale):
            if dtype == torch.bfloat16:
                return ops.qmatmul(x.to(torch.bfloat16), codes, scale, bits)
            w = unpack_int4(codes) if bits == 4 else codes
            acc = torch.matmul(x.to(dtype).to(torch.float32),
                               w.to(dtype).to(torch.float32))
            return (acc * scale).to(dtype)

        if D.is_dtensor(codes):
            # each rank runs the kernel on its own columns of the codes
            y = D.local_columns(x, codes, scale, product)
        else:
            y = product(x, codes, scale)
    else:
        w = fake_quant(p["w"], wspec) if wspec is not None else p["w"]
        if D.is_dtensor(w):
            # FSDP gathers the weight's input dim, and x is made whole along
            # it: no contraction is split over ranks (no partial sums)
            w, x = D.unshard(w, (-2,)), D.unshard(x, (-1,))
        # the gradient in the output's layout: W's gradient stays split
        y = D.grad_as_value(torch.matmul(x.to(dtype), w.to(dtype)))
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


def layernorm_init(d: int, stack: Tuple[int, ...] = (),
                   device: torch.device = torch.device("cpu")) -> Params:
    return {"g": torch.ones((*stack, d), dtype=torch.float32, device=device),
            "b": torch.zeros((*stack, d), dtype=torch.float32, device=device)}


def layernorm(p: Params, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm in float32 (mean, then the mean square of the centred
    values), cast back to x's dtype."""
    xf = x.to(torch.float32)
    xc = xf - torch.mean(xf, dim=-1, keepdim=True)
    var = torch.mean(xc * xc, dim=-1, keepdim=True)
    return (xc * torch.rsqrt(var + eps) * p["g"] + p["b"]).to(x.dtype)


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
    return _rotate(x, ang)


def _rotate(x: torch.Tensor, ang: torch.Tensor) -> torch.Tensor:
    """Rotate x's interleaved pairs by ``ang`` (B, S, hd/2), shared by
    every head."""
    cos, sin = torch.cos(ang)[:, :, None, :], torch.sin(ang)[:, :, None, :]
    x1, x2 = x[..., 0::2], x[..., 1::2]
    out = torch.stack([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return D.reshape(out, *x.shape).to(x.dtype)


@functools.lru_cache(maxsize=None)
def _mrope_runs(n: int, sections: Tuple[int, ...]) -> Tuple[Tuple[int, int], ...]:
    """(stream, pairs) runs over the ``n`` frequency pairs.  Pair ``i`` is
    rotated by stream (0 t, 1 h, 2 w) ``jnp.searchsorted(bounds, i,
    side="right")`` clipped to 2, as the reference, with ``round(n * s /
    total)`` pairs a section (Python's rounding) and the last bound ``n``.
    Python ints, so a captured decode step copies nothing from the host."""
    total = sum(sections)
    bounds, acc = [], 0
    for s in sections:
        acc += round(n * s / total)
        bounds.append(acc)
    bounds[-1] = n
    runs: List[List[int]] = []
    for i in range(n):
        stream = min(sum(b <= i for b in bounds), 2)
        if runs and runs[-1][0] == stream:
            runs[-1][1] += 1
        else:
            runs.append([stream, 1])
    return tuple((stream, k) for stream, k in runs)


def apply_mrope(x: torch.Tensor, positions3: torch.Tensor, theta: float,
                sections=(2, 3, 3)) -> torch.Tensor:
    """Qwen2-VL multimodal RoPE: positions3 (3, B, S) = (t, h, w) ids.

    The hd/2 frequency pairs split into ``sections``, each rotated by its
    own position stream (:func:`_mrope_runs`).  Text tokens carry t == h
    == w, which is plain RoPE."""
    hd = x.shape[-1]
    freqs = _rope_freqs(hd, theta, x.device)
    pos = torch.cat([positions3[stream][..., None].expand(
        *positions3.shape[1:], k)
        for stream, k in _mrope_runs(hd // 2, tuple(sections))], dim=-1)
    ang = pos.to(torch.float32) * freqs                          # (B, S, n)
    return _rotate(x, ang)


# ---------------------------------------------------------------------------
# Attention (GQA + KV cache + chunked/flash prefill)
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
    qh = D.reshape(q, B, Sq, KV, H // KV, hd)
    return torch.einsum("bqgrh,bkgh->bgrqk", qh.to(torch.float32),
                        k.to(torch.float32)) / math.sqrt(hd)


def _gqa_mix(w: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Softmax weights (B, KV, rep, Sq, Sk) x v (B, Sk, KV, hd) ->
    float32 (B, Sq, H, hd)."""
    out = torch.einsum("bgrqk,bkgh->bqgrh", w, v.to(torch.float32))
    B, Sq, KV, rep, hd = out.shape
    return D.reshape(out, B, Sq, KV * rep, hd)


def _sdpa(q, k, v, causal: bool, q_offset: int = 0) -> torch.Tensor:
    """Plain attention: q (B,Sq,H,hd), k/v (B,Sk,KV,hd).  GQA broadcast.
    On DTensors each rank attends with its own heads
    (:func:`~repro_torch.dist.dtensor.by_heads`)."""
    q = constrain(q, "attn_q_rows")
    return D.by_heads(lambda q, k, v: _sdpa_heads(q, k, v, causal,
                                                  q_offset), q, k, v)


def _sdpa_heads(q, k, v, causal: bool, q_offset: int) -> torch.Tensor:
    scores = _gqa_scores(q, k)
    if causal:
        iq = torch.arange(q.shape[1], device=q.device) + q_offset
        ik = torch.arange(k.shape[1], device=q.device)
        scores = scores.masked_fill(ik[None, :] > iq[:, None], -math.inf)
    w = torch.softmax(scores, dim=-1)
    return _gqa_mix(w, v).to(q.dtype)


# The largest score tile, per batch row and head, that a group of query
# blocks takes in one step of :func:`_chunked_heads`: the tile one block of
# 1,024 rows (every real config's ``prefill_chunk``) takes alone.
_GROUP_TILE = 1024 * 1024


def _chunked_sdpa(q, k, v, chunk: int, causal: bool = True) -> torch.Tensor:
    """Flash-style online-softmax attention: q blocks of ``chunk`` rows,
    each over the kv blocks with a running (max, denominator, accumulator)
    in float32, as the reference's scans.

    The q blocks advance in groups of ``g``, the most whose score tile
    ``g·chunk²`` stays within ``_GROUP_TILE`` (``g`` is 1 at a chunk of
    1,024), so a short chunk takes one step per kv block, not per block
    pair.  Every row still takes kv blocks 0 up to its own diagonal in
    order with the same ops; rows of a group past their diagonal keep their
    carry (``_causal_kv_scan``'s ``where(keep, new, old)``), and no kv
    block past the group's last diagonal is computed."""
    return D.by_heads(lambda q, k, v: _chunked_heads(q, k, v, chunk, causal),
                      q, k, v)


def _group_blocks(nq: int, chunk: int) -> int:
    """Query blocks a group of :func:`_chunked_heads` takes."""
    return max(1, min(nq, _GROUP_TILE // (chunk * chunk)))


def _chunked_heads(q, k, v, chunk: int, causal: bool) -> torch.Tensor:
    B, Sq, H, hd = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    rep = H // KV
    nq, nk = Sq // chunk, Sk // chunk
    g = _group_blocks(nq, chunk)
    qb = D.reshape(q, B, nq, chunk, KV, rep, hd)
    kb = D.reshape(k, B, nk, chunk, KV, hd)
    vb = D.reshape(v, B, nk, chunk, KV, hd)
    scale = 1.0 / math.sqrt(hd)
    cols = torch.arange(chunk, device=q.device)
    groups = []
    for q0 in range(0, nq, g):
        n = min(g, nq - q0)
        rows = q0 * chunk + torch.arange(n * chunk, device=q.device)
        qi = constrain(D.reshape(qb[:, q0:q0 + n], B, n * chunk, KV, rep, hd)
                       .to(torch.float32), "attn_chunk_q")
        m = torch.full((B, KV, rep, n * chunk), -math.inf,
                       dtype=torch.float32, device=q.device)
        den = torch.zeros((B, KV, rep, n * chunk), dtype=torch.float32,
                          device=q.device)
        acc = torch.zeros((B, n * chunk, KV, rep, hd), dtype=torch.float32,
                          device=q.device)
        for ik in range(min(q0 + n, nk) if causal else nk):
            kj = kb[:, ik].to(torch.float32)
            vj = vb[:, ik].to(torch.float32)
            s = torch.einsum("bqgrh,bkgh->bgrqk", qi, kj) * scale
            if causal:
                keep = (ik * chunk + cols)[None, :] <= rows[:, None]
                s = torch.where(keep, s, -math.inf)
            m_new = torch.maximum(m, s.amax(-1))
            pr = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            den_new = den * corr + pr.sum(-1)
            acc_new = (acc * corr.permute(0, 3, 1, 2)[..., None]
                       + torch.einsum("bgrqk,bkgh->bqgrh", pr, vj))
            if causal and ik > q0:
                # the group's rows of blocks before ik are past their
                # diagonal: they keep their carry
                live = rows >= ik * chunk
                m_new = torch.where(live, m_new, m)
                den_new = torch.where(live, den_new, den)
                acc_new = torch.where(live[:, None, None, None], acc_new, acc)
            m, den, acc = m_new, den_new, acc_new
        out = acc / den.permute(0, 3, 1, 2)[..., None]
        groups.append(out.to(q.dtype))
    return D.reshape(torch.cat(groups, dim=1), B, Sq, H, hd)


def attention(p: Params, x: torch.Tensor, cfg, positions: torch.Tensor, *,
              cache: Optional[Params] = None, causal: bool = True,
              kv_source: Optional[torch.Tensor] = None,
              positions3: Optional[torch.Tensor] = None,
              wspec: Optional[FixedPointSpec] = None
              ) -> Tuple[torch.Tensor, Optional[Params]]:
    """GQA attention.  Modes:

    * train/prefill: ``cache`` is None (full sequence); returns (out, None);
    * prefill with a cache dict: fills the cache, returns (out, cache);
    * decode: x is (B, 1, d); the cache holds k, v (B, Smax, KV, hd) and a
      0-d ``len``; positions at ``len`` and beyond are masked;
    * cross-attention: k and v from ``kv_source`` (B, Senc, d), not
      rotated; or, with a cache that has no ``len`` (whisper's decode),
      q alone against the cache's precomputed k and v.

    ``cfg.pos == "mrope"`` rotates q and k by ``positions3`` (3, B, S).  A
    causal self-attention longer than twice ``cfg.prefill_chunk`` and a
    multiple of it runs :func:`_chunked_sdpa`, as in the reference.

    The cache's ``k`` and ``v`` are written in place at ``len`` (the
    reference's jitted step donates them), and the returned cache holds the
    same tensors with ``len + S``.
    """
    B, S, _ = x.shape
    hd, H, KV = cfg.hd, cfg.n_heads, cfg.n_kv_heads
    q = constrain(D.reshape(dense(p["wq"], x, wspec), B, S, H, hd),
                  "attn_heads")
    if cache is not None and "len" not in cache:
        # pure cross-attention against a precomputed KV cache
        out = _sdpa(q, cache["k"], cache["v"], causal=False)
        return dense(p["wo"], D.reshape(out, B, S, H * hd), wspec), None

    src = x if kv_source is None else kv_source
    Skv = src.shape[1]
    k = constrain(D.reshape(dense(p["wk"], src, wspec), B, Skv, KV, hd),
                  "attn_heads")
    v = constrain(D.reshape(dense(p["wv"], src, wspec), B, Skv, KV, hd),
                  "attn_heads")
    if "q_norm" in p:
        q = rmsnorm(p["q_norm"], q)
        k = rmsnorm(p["k_norm"], k)
    if kv_source is None:               # rope applies to self-attention only
        if cfg.pos == "rope":
            q = apply_rope(q, positions, cfg.rope_theta)
            k = apply_rope(k, positions, cfg.rope_theta)
        elif cfg.pos == "mrope":
            q = apply_mrope(q, positions3, cfg.rope_theta)
            k = apply_mrope(k, positions3, cfg.rope_theta)

    new_cache = None
    if cache is not None and kv_source is None:
        idx = cache["len"]
        rows = idx.to(torch.int64) + torch.arange(S, device=x.device)
        D.index_copy_(cache["k"], 1, rows, k.to(cache["k"].dtype))
        D.index_copy_(cache["v"], 1, rows, v.to(cache["v"].dtype))
        new_cache = {"k": cache["k"], "v": cache["v"], "len": idx + S}
        k, v = cache["k"], cache["v"]
        if S == 1:
            # decode: mask positions beyond the current length
            valid = torch.arange(k.shape[1], device=x.device) < (idx + 1)

            def decode(q, k, v):
                # a rank's own heads: the (replicated) mask's local copy
                keep = valid.to_local() if D.is_dtensor(valid) \
                    and not D.is_dtensor(q) else valid
                scores = _gqa_scores(q, k).masked_fill(~keep, -math.inf)
                return _gqa_mix(torch.softmax(scores, dim=-1), v)

            out = D.by_heads(decode, q, k, v).to(x.dtype)
            return (dense(p["wo"], D.reshape(out, B, 1, H * hd), wspec),
                    new_cache)
    elif cache is not None:
        # cross-attention with a cache that has a length: its k and v, as
        # the reference reads them (the projections above go unused)
        k, v = cache["k"], cache["v"]

    if causal and S > 2 * cfg.prefill_chunk and S % cfg.prefill_chunk == 0:
        out = _chunked_sdpa(q, k, v, cfg.prefill_chunk, causal=True)
    else:
        out = _sdpa(q, k, v, causal=causal and kv_source is None)
    return dense(p["wo"], D.reshape(out, B, S, H * hd), wspec), new_cache


# ---------------------------------------------------------------------------
# MLA: Multi-head Latent Attention (MiniCPM3 / DeepSeek-style)
# ---------------------------------------------------------------------------
def mla_init(gen: torch.Generator, cfg, stack: Tuple[int, ...] = (),
             device: torch.device = torch.device("cpu")) -> Params:
    d, H = cfg.d_model, cfg.n_heads
    hd, rd = cfg.hd, cfg.mla_rope_dim
    vhd = cfg.mla_v_head_dim or hd
    qr, kvr = cfg.mla_q_rank, cfg.mla_kv_rank
    kw = dict(stack=stack, device=device)
    return {"wq_a": dense_init(gen, d, qr, **kw),
            "q_a_norm": rmsnorm_init(qr, **kw),
            "wq_b": dense_init(gen, qr, H * (hd + rd), **kw),
            "wkv_a": dense_init(gen, d, kvr + rd, **kw),
            "kv_a_norm": rmsnorm_init(kvr, **kw),
            "wkv_b": dense_init(gen, kvr, H * (hd + vhd), **kw),
            "wo": dense_init(gen, H * vhd, d, **kw)}


def dense_weight(p: Params) -> torch.Tensor:
    """A dense leaf's weight matrix as float: ``w``, or serving codes
    (int4 unpacked) times their per-column scale, in float32."""
    if "w_codes" not in p:
        return p["w"]
    codes, scale = p["w_codes"], p["w_scale"]
    if codes.shape[-1] != scale.shape[-1]:
        codes = unpack_int4(codes)
    return codes.to(torch.float32) * scale[..., None, :]


def mla_attention(p: Params, x: torch.Tensor, cfg, positions: torch.Tensor,
                  *, cache: Optional[Params] = None, wspec=None
                  ) -> Tuple[torch.Tensor, Optional[Params]]:
    """MLA with the compressed cache (the latent ``c_kv`` and the shared
    rope key ``k_pe``).

    Prefill and training use the expanded form (k and v rebuilt from the
    latent, v padded to q's width and sliced back); decode the absorbed
    form: q is projected into the latent space, so attention reads the
    (B, S, kv_rank) cache with no per-step expansion.  The decode writes
    its ``c_kv`` and ``k_pe`` rows in place at the cache's length.  A
    quantized ``wkv_b`` is dequantized (:func:`dense_weight`) for the two
    einsums that read it.
    """
    B, S, _ = x.shape
    H, hd, rd = cfg.n_heads, cfg.hd, cfg.mla_rope_dim
    vhd = cfg.mla_v_head_dim or hd
    kvr = cfg.mla_kv_rank
    scale = 1.0 / math.sqrt(hd + rd)
    f32 = torch.float32

    q = D.reshape(dense(p["wq_b"], rmsnorm(p["q_a_norm"],
                                           dense(p["wq_a"], x, wspec)),
                        wspec), B, S, H, hd + rd)
    q_nope = q[..., :hd]
    q_pe = apply_rope(q[..., hd:], positions, cfg.rope_theta)

    kv_a = dense(p["wkv_a"], x, wspec)                       # (B, S, kvr + rd)
    c_kv = rmsnorm(p["kv_a_norm"], kv_a[..., :kvr])          # the latent
    k_pe = apply_rope(D.reshape(kv_a[..., kvr:], B, S, 1, rd), positions,
                      cfg.rope_theta)                        # shared by heads

    w_kv_b = D.reshape(dense_weight(p["wkv_b"]), kvr, H, hd + vhd)
    w_uk, w_uv = w_kv_b[..., :hd].to(f32), w_kv_b[..., hd:].to(f32)

    def write(c):
        idx = c["len"]
        rows = idx.to(torch.int64) + torch.arange(S, device=x.device)
        D.index_copy_(c["c_kv"], 1, rows, c_kv.to(c["c_kv"].dtype))
        D.index_copy_(c["k_pe"], 1, rows, k_pe[:, :, 0].to(c["k_pe"].dtype))
        return {"c_kv": c["c_kv"], "k_pe": c["k_pe"], "len": idx + S}

    if cache is not None and S == 1:                # absorbed decode
        new_cache = write(cache)
        cc, cp = cache["c_kv"].to(f32), cache["k_pe"].to(f32)
        q_lat = torch.einsum("bqhd,rhd->bqhr", q_nope.to(f32), w_uk)
        s_nope = torch.einsum("bqhr,bkr->bhqk", q_lat, cc)
        s_pe = torch.einsum("bqhd,bkd->bhqk", q_pe.to(f32), cp)
        s = (s_nope + s_pe) * scale
        valid = torch.arange(cc.shape[1], device=x.device) < (cache["len"]
                                                              + 1)
        w = torch.softmax(s.masked_fill(~valid, -math.inf), dim=-1)
        ctx = torch.einsum("bhqk,bkr->bqhr", w, cc)
        out = torch.einsum("bqhr,rhv->bqhv", ctx, w_uv)
        y = dense(p["wo"], D.reshape(out, B, 1, H * vhd).to(x.dtype),
                  wspec)
        return y, new_cache

    # expanded prefill / train path
    k_nope = torch.einsum("bkr,rhd->bkhd", c_kv.to(f32), w_uk).to(x.dtype)
    v = torch.einsum("bkr,rhv->bkhv", c_kv.to(f32), w_uv).to(x.dtype)
    k = torch.cat([k_nope, k_pe.expand(B, S, H, rd)], dim=-1)
    qfull = torch.cat([q_nope, q_pe], dim=-1)
    vpad = torch.nn.functional.pad(v, (0, hd + rd - vhd))
    if S > 2 * cfg.prefill_chunk and S % cfg.prefill_chunk == 0:
        out = _chunked_sdpa(qfull, k, vpad, cfg.prefill_chunk)[..., :vhd]
    else:
        out = _sdpa(qfull, k, vpad, causal=True)[..., :vhd]
    y = dense(p["wo"], D.reshape(out, B, S, H * vhd), wspec)
    # a prefill fills the compressed cache
    return y, (None if cache is None else write(cache))


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


# ---------------------------------------------------------------------------
# MoE (top-k, capacity-based dropping dispatch)
# ---------------------------------------------------------------------------
def _expert_bank(gen: torch.Generator, lead: Tuple[int, ...], k: int, n: int,
                 lim: float, device: torch.device, bits: int):
    """A (*lead, k, n) bank of uniform(-lim, lim) weights, drawn one (k, n)
    expert at a time.  With ``bits`` (8 or 4) each expert is quantized as
    it is drawn (:func:`quantize_dense_for_serving`'s rule) into stacked
    codes and scales, so no float bank of a layer exists whole; the draws
    are the same either way."""
    count = math.prod(lead)
    if not bits:
        out = torch.empty((count, k, n), dtype=torch.float32, device=device)
        for i in range(count):
            out[i] = _uniform(gen, (k, n), -lim, lim, device)
        return out.reshape(*lead, k, n)
    codes = torch.empty((count, k, n // 2 if bits == 4 else n),
                        dtype=torch.int8, device=device)
    scale = torch.empty((count, n), dtype=torch.float32, device=device)
    for i in range(count):
        q = quantize_dense_for_serving(
            {"w": _uniform(gen, (k, n), -lim, lim, device)}, bits)
        codes[i], scale[i] = q["w_codes"], q["w_scale"]
    return {"w_codes": codes.reshape(*lead, *codes.shape[1:]),
            "w_scale": scale.reshape(*lead, n)}


def moe_init(gen: torch.Generator, cfg, stack: Tuple[int, ...] = (),
             device: torch.device = torch.device("cpu"),
             bits: int = 0) -> Params:
    """The router, the stacked expert banks ``w_gate``/``w_up`` (E, d, f)
    and ``w_down`` (E, f, d), uniform in ±1/sqrt(fan-in), and arctic's
    dense residual MLP.  ``bits`` stores the banks as serving codes
    (:func:`_expert_bank`)."""
    d, f, E = cfg.d_model, cfg.d_ff, cfg.moe_experts
    lead = (*stack, E)
    p = {"router": dense_init(gen, d, E, stack=stack, device=device),
         "w_gate": _expert_bank(gen, lead, d, f, 1 / math.sqrt(d), device,
                                bits),
         "w_up": _expert_bank(gen, lead, d, f, 1 / math.sqrt(d), device,
                              bits),
         "w_down": _expert_bank(gen, lead, f, d, 1 / math.sqrt(f), device,
                                bits)}
    if cfg.moe_dense_residual:
        p["dense_mlp"] = mlp_init(gen, d, f, cfg.act, stack, device)
    return p


def moe_route(p: Params, flat: torch.Tensor, cfg):
    """(probs (T, E), gate values (T, k), expert ids (T, k)): the float32
    router (``dense`` in float32, on codes too), its softmax, the k largest
    probabilities in descending order with ties to the lower expert id
    (``jax.lax.top_k``'s order, from a stable descending sort), and the
    gates renormalised to sum to one."""
    logits = dense(p["router"], flat, None, dtype=torch.float32)
    probs = torch.softmax(logits.to(torch.float32), dim=-1)
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    k = cfg.moe_top_k
    gates = vals[:, :k]
    gates = gates / torch.clamp_min(gates.sum(-1, keepdim=True), 1e-9)
    return probs, gates, idx[:, :k]


def _expert(bank: Params, e: int) -> Params:
    return {"w_codes": bank["w_codes"][e], "w_scale": bank["w_scale"][e]}


def moe_slots(ids: torch.Tensor, E: int, C: int,
              base: Optional[torch.Tensor] = None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(keep, slot) of each (token, choice) entry of ``ids`` (Tk,): its
    rank within its expert from a one-hot cumulative sum, plus ``base``
    (E,) of its expert where given (the entries of earlier ranks); ranks
    past the capacity ``C`` are dropped to the overflow slot ``C``."""
    one = (ids[:, None] == torch.arange(E, device=ids.device)
           ).to(torch.int32)                                    # (Tk, E)
    pos = ((torch.cumsum(one, 0) - one) * one).sum(-1)          # rank
    if base is not None:
        pos = pos + base[ids]
    keep = pos < C
    return keep, torch.where(keep, pos, C)                      # C: overflow


def moe_dispatch(flat: torch.Tensor, ids: torch.Tensor, E: int, C: int,
                 expert_parallel: bool = True):
    """(buf (E, C, d), route): each kept (token, choice) row of ``flat``
    (T, d) in its expert's slot of the buffer, the rest zeros.

    On plain tensors (and on DTensors with ``expert_parallel`` off: the
    served banks of codes) ``route`` is (ids, slots, keep) for
    :func:`moe_combine`; with DTensors the scatter runs on replicated
    copies (:func:`repro_torch.dist.dtensor.index_put`).  Otherwise
    ``route`` is a :class:`repro_torch.dist.dtensor.ExpertDispatch`: each
    rank scatters its own tokens and an all-to-all over the expert axis
    (:func:`~repro_torch.dist.sharding.moe_expert_axis`) brings each
    expert its rows, in the same slots; its ``keep`` is the kept mask.
    """
    if expert_parallel and D.is_dtensor(flat):
        route = D.ExpertDispatch(flat, ids, E, C, moe_expert_axis(),
                                 moe_slots)
        return route.buf, route
    T, d = flat.shape
    k = ids.shape[0] // T
    keep, pos_c = moe_slots(ids, E, C)
    tok = torch.arange(T, device=flat.device)[:, None].expand(T, k).reshape(-1)
    cd = flat.dtype
    buf = D.index_put(torch.zeros((E, C + 1, d), dtype=cd, device=flat.device),
                      (ids, pos_c), flat[tok] * keep[:, None].to(cd))
    return buf[:, :C], (ids, pos_c, keep)


def moe_combine(out_buf: torch.Tensor, gates: torch.Tensor, route
                ) -> torch.Tensor:
    """(T, d): the sum of each token's k rows of ``out_buf`` (E, C, d),
    each weighted by its gate (``gates`` (T, k)), dropped entries 0."""
    if isinstance(route, D.ExpertDispatch):
        return route.combine(out_buf, gates)
    ids, pos_c, keep = route
    E, _, d = out_buf.shape
    T, k = gates.shape
    cd = out_buf.dtype
    out_buf = torch.cat([out_buf, torch.zeros((E, 1, d), dtype=cd,
                                              device=out_buf.device)], dim=1)
    weighted = out_buf[ids, pos_c] * (gates.reshape(T * k, 1).to(cd)
                                      * keep[:, None].to(cd))
    return D.reshape(weighted, T, k, d).sum(1)


def moe(p: Params, x: torch.Tensor, cfg, wspec=None, aspec=None
        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (output, the Switch load-balance aux loss).

    Sort-free capacity dispatch, as the reference (:func:`moe_slots`):
    each (token, choice) gets its rank within its expert from a one-hot
    cumulative sum; ranks past the capacity ``C = max(int(capacity_factor
    * T * k / E), 1)`` (a Python int fixed by the shape) go to the
    overflow row ``C`` as zeros and are sliced away, so their writes may
    land in any order.  No step reads a value on the host, so a CUDA graph
    captures it.

    Float banks (bits 0, training) run the experts as batched einsums;
    banks of serving codes run each expert's three products through
    :func:`dense` on its codes (``qmatmul`` in bf16, the float32 codes
    product in float32).  On DTensors the float banks run expert-parallel
    (:func:`moe_dispatch`): each bank moves to the buffer's expert layout
    with its input dim whole (FSDP's gather) and its output columns kept,
    and ``h`` is made whole along ``f`` before ``w_down``, so no
    contraction is split over ranks.
    """
    B, S, d = x.shape
    E, k = cfg.moe_experts, cfg.moe_top_k
    T = B * S
    C = max(int(cfg.moe_capacity_factor * T * k / E), 1)
    flat = D.reshape(x, T, d)
    cd = x.dtype
    codes = isinstance(p["w_gate"], dict)
    if not codes:
        # the router and the dispatch read the tokens whole along d
        flat = D.unshard(flat, (1,))

    probs, gates, idx = moe_route(p, flat, cfg)
    experts = torch.arange(E, device=x.device)
    me = (idx[:, :1] == experts).to(torch.float32).mean(0)
    aux = E * torch.sum(me * probs.mean(0))

    buf, route = moe_dispatch(flat, idx.reshape(T * k), E, C,
                              expert_parallel=not codes)
    buf = constrain(buf, "moe_dispatch")            # EP all-to-all boundary

    if codes:                                       # serving codes
        outs = []
        for e in range(E):
            be = buf[e]
            h = silu(dense(_expert(p["w_gate"], e), be, dtype=cd)) \
                * dense(_expert(p["w_up"], e), be, dtype=cd)
            outs.append(dense(_expert(p["w_down"], e), fake_quant(h, aspec),
                              dtype=cd))
        out_buf = torch.stack(outs)
    else:
        ea = (route.experts_axis if isinstance(route, D.ExpertDispatch)
              else None)
        wg, wu, wd = (D.experts_on((fake_quant(p[n], wspec) if wspec
                                    else p[n]).to(cd), ea)
                      for n in ("w_gate", "w_up", "w_down"))
        h = silu(torch.einsum("ecd,edf->ecf", buf, wg)) \
            * torch.einsum("ecd,edf->ecf", buf, wu)
        out_buf = torch.einsum("ecf,efd->ecd",
                               D.unshard(fake_quant(h, aspec), (2,)), wd)
    y = moe_combine(out_buf, gates, route)
    if "dense_mlp" in p:            # arctic's parallel dense residual branch
        y = y + mlp(p["dense_mlp"], flat, cfg.act, wspec, aspec)
    return D.reshape(y, B, S, d), aux


# ---------------------------------------------------------------------------
# Mamba2 (SSD: state-space duality, chunked)
# ---------------------------------------------------------------------------
def mamba_init(gen: torch.Generator, cfg, stack: Tuple[int, ...] = (),
               device: torch.device = torch.device("cpu"),
               d_model: Optional[int] = None) -> Params:
    """The reference's Mamba2 block parameters: ``in_proj`` to (z, x, B, C,
    dt), a depthwise causal conv N(0, 0.01) over (x, B, C), ``A_log`` =
    log(linspace(1, 16)) per head, ``D`` 1, ``dt_bias`` 0, the gated
    RMSNorm's gain and ``out_proj``."""
    d = d_model or cfg.d_model
    di, N, G = cfg.ssm_expand * d, cfg.ssm_state, cfg.ssm_groups
    nh = di // cfg.ssm_head_dim
    conv_dim = di + 2 * G * N
    kw = dict(stack=stack, device=device)
    conv_w = torch.randn((*stack, cfg.ssm_conv, conv_dim), generator=gen,
                         dtype=torch.float32, device=gen.device)
    a_log = torch.log(torch.linspace(1.0, 16.0, nh, dtype=torch.float32))

    def per_layer(t):
        return t.to(device).expand(*stack, *t.shape).clone()

    return {
        "in_proj": dense_init(gen, d, 2 * di + 2 * G * N + nh, **kw),
        "conv_w": conv_w.mul_(0.1).to(device),
        "conv_b": torch.zeros((*stack, conv_dim), dtype=torch.float32,
                              device=device),
        "A_log": per_layer(a_log),
        "D": torch.ones((*stack, nh), dtype=torch.float32, device=device),
        "dt_bias": torch.zeros((*stack, nh), dtype=torch.float32,
                               device=device),
        "gnorm": rmsnorm_init(di, **kw),
        "out_proj": dense_init(gen, di, d, **kw),
    }


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 state: Optional[torch.Tensor] = None):
    """Depthwise causal conv1d, then silu.  x (B, S, C), w (K, C).  Returns
    (y, new_state): the state is the last K-1 inputs, in x's dtype (the
    caller stores it)."""
    K, S = w.shape[0], x.shape[1]
    if state is None:
        pad = torch.zeros((x.shape[0], K - 1, x.shape[2]), dtype=x.dtype,
                          device=x.device)
    else:
        pad = state.to(x.dtype)
    xp = torch.cat([pad, x], dim=1)
    y = xp[:, 0:S] * w[0]
    for i in range(1, K):
        y = y + xp[:, i:i + S] * w[i]
    new_state = xp[:, -(K - 1):] if K > 1 else None
    return silu(y + b), new_state


def _segsum(a_log: torch.Tensor) -> torch.Tensor:
    """L[i, j] = exp(sum_{j < m <= i} a_log_m), the lower-triangular decay
    matrix: (..., Q) -> (..., Q, Q).  The upper triangle is masked before
    the exp, as the reference does: its large positive sums would overflow,
    and 0 x inf in the backward would poison the whole gradient."""
    Q = a_log.shape[-1]
    cs = torch.cumsum(a_log, dim=-1)
    dif = cs[..., :, None] - cs[..., None, :]
    mask = torch.ones((Q, Q), dtype=torch.bool, device=a_log.device).tril()
    return torch.exp(torch.where(mask, dif, -math.inf))


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: ``logaddexp(x, 0)``.  ``F.softplus`` switches
    to ``x`` above its threshold and rounds another formula."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device))


def _repeat_heads(t: torch.Tensor, rep: int, dim: int) -> torch.Tensor:
    """``jnp.repeat(t, rep, axis=dim)``: each group ``rep`` times in a row
    (a view where the groups number 1)."""
    t = t.unsqueeze(dim + 1)
    shape = list(t.shape)
    shape[dim + 1] = rep
    return t.expand(shape).flatten(dim, dim + 1)


def mamba_apply(p: Params, u: torch.Tensor, cfg, *,
                state: Optional[Params] = None, wspec=None
                ) -> Tuple[torch.Tensor, Optional[Params]]:
    """Mamba2 SSD block.  u: (B, S, d).

    Train/prefill: the chunked SSD (quadratic within a chunk of
    ``min(cfg.ssm_chunk, S)`` positions, a recurrence over the chunks'
    states).  Decode (S == 1 with a state): the O(1) recurrent update.

    ``state`` ({"conv": (B, K-1, C) in the cache dtype, "ssm": (B, nh, P,
    N) float32}) is updated in place and returned; without one the result
    carries no state."""
    B, S, d = u.shape
    di = cfg.ssm_expand * d
    N, G, P = cfg.ssm_state, cfg.ssm_groups, cfg.ssm_head_dim
    nh = di // P
    proj = dense(p["in_proj"], u, wspec)
    z, xBC, dt = torch.split(proj, [di, di + 2 * G * N, nh], dim=-1)

    xBC, new_conv = _causal_conv(xBC, p["conv_w"], p["conv_b"],
                                 None if state is None else state["conv"])
    x, B_, C_ = torch.split(xBC, [di, G * N, G * N], dim=-1)
    x = D.reshape(x, B, S, nh, P)
    B_ = D.reshape(B_, B, S, G, N)
    C_ = D.reshape(C_, B, S, G, N)
    dt = _softplus(dt.to(torch.float32) + p["dt_bias"])          # (B, S, nh)
    A = -torch.exp(p["A_log"])                                   # (nh,)
    a_log = (dt * A).to(torch.float32)                           # (B, S, nh)
    xdt = x.to(torch.float32) * dt[..., None]                    # (B, S, nh, P)
    rep = nh // G

    if S == 1 and state is not None:                    # -------- decode
        ssm = state["ssm"]                                       # (B, nh, P, N)
        Bg = _repeat_heads(B_[:, 0], rep, 1)                     # (B, nh, N)
        Cg = _repeat_heads(C_[:, 0], rep, 1)
        ssm.mul_(torch.exp(a_log[:, 0])[..., None, None]).add_(
            xdt[:, 0][..., None] * Bg[:, :, None, :])
        state["conv"].copy_(new_conv)
        y = torch.einsum("bhpn,bhn->bhp", ssm, Cg.to(torch.float32))
        y = y + p["D"][None, :, None] * x[:, 0].to(torch.float32)
        y = D.reshape(y, B, 1, di).to(u.dtype)
        y = rmsnorm(p["gnorm"], y * silu(z))
        return dense(p["out_proj"], y, wspec), state

    # -------- chunked SSD (train / prefill)
    Q = min(cfg.ssm_chunk, S)
    assert S % Q == 0, f"seq {S} must divide ssm_chunk {Q}"
    nc = S // Q
    xdt_c = D.reshape(xdt, B, nc, Q, nh, P)
    B_c = D.reshape(B_, B, nc, Q, G, N)
    C_c = D.reshape(C_, B, nc, Q, G, N)
    al_c = D.reshape(a_log, B, nc, Q, nh)

    L = _segsum(al_c.permute(0, 1, 3, 2))                        # (B, nc, nh, Q, Q)
    Bh = _repeat_heads(B_c, rep, 3).to(torch.float32)            # (B, nc, Q, nh, N)
    Ch = _repeat_heads(C_c, rep, 3).to(torch.float32)
    att = torch.einsum("bcqhn,bckhn->bchqk", Ch, Bh) * L
    Y_diag = torch.einsum("bchqk,bckhp->bcqhp", att, xdt_c)

    cs = torch.cumsum(al_c, dim=2)
    seg_end = torch.exp(al_c.sum(2, keepdim=True) - cs)
    S_chunk = torch.einsum("bcqhn,bcqhp,bcqh->bchpn", Bh, xdt_c, seg_end)
    a_chunk = torch.exp(al_c.sum(2))                             # (B, nc, nh)

    s = (torch.zeros((B, nh, P, N), dtype=torch.float32, device=u.device)
         if state is None else state["ssm"])
    prev = []
    for c in range(nc):
        prev.append(s)
        s = s * a_chunk[:, c][..., None, None] + S_chunk[:, c]
    prev_states = torch.stack(prev, dim=1)                       # (B, nc, nh, P, N)

    decay_in = torch.exp(cs)                                     # (B, nc, Q, nh)
    Y_off = torch.einsum("bcqhn,bchpn,bcqh->bcqhp", Ch, prev_states, decay_in)

    y = D.reshape(Y_diag + Y_off, B, S, nh, P)
    y = y + p["D"][None, None, :, None] * x.to(torch.float32)
    y = D.reshape(y, B, S, di).to(u.dtype)
    y = rmsnorm(p["gnorm"], y * silu(z))
    out = dense(p["out_proj"], y, wspec)
    if state is None:
        return out, None
    state["conv"].copy_(new_conv)
    state["ssm"].copy_(s)
    return out, state
