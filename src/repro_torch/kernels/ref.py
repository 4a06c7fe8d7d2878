"""Plain PyTorch versions of every kernel on the port's path.

These are the semantic ground truth, op for op the JAX package's
``kernels/ref.py``: the CPU execution path of the port, and the bar each
hand-written CUDA kernel is held to on the card (``chip_smoke.py``).

Integer matmuls: PyTorch multiplies int32 matrices on the CPU (with the
same wrapping int32 arithmetic as the reference) but not on CUDA.  On a
CUDA tensor the plain integer product runs in float64, which is exact for
every graph the integer lowering admits: it refuses any layer whose
partial sums leave int32, far inside float64's 53-bit mantissa.
"""

from __future__ import annotations

import math

import torch

from repro_torch.core import quant
from repro_torch.device import ieee_f32


def _f32_matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    if x.is_cuda:
        ieee_f32()
    return torch.matmul(x.to(torch.float32), w.to(torch.float32))


def mvau(x: torch.Tensor, w: torch.Tensor, thresholds: torch.Tensor,
         out_base: int = 0, out_scale: float = 1.0,
         out_bias: float = 0.0) -> torch.Tensor:
    """Matrix-Vector-Activation Unit: ``threshold_count(x @ w)``.

    x: (..., K) float (values on a fixed-point grid), w: (K, N),
    thresholds: (L,) or (N, L).  Output: float32
    ``out_scale * (out_base + Σᵢ 1[y ≥ Tᵢ]) + out_bias``.
    """
    y = _f32_matmul(x, w)
    return quant.multithreshold(y, thresholds, out_base, out_scale, out_bias)


def im2col(x: torch.Tensor, kernel: int, stride: int, pad: int) -> torch.Tensor:
    """NHWC patch extraction -> (N, OH, OW, KH*KW*C), patch order
    (kh, kw, c), zero outside the image.  FINN's Conv lowering."""
    k, s, p = kernel, stride, pad
    n, h, w, c = x.shape
    xp = torch.nn.functional.pad(x, (0, 0, p, p, p, p))
    oh = (h + 2 * p - k) // s + 1
    ow = (w + 2 * p - k) // s + 1
    ar_k = torch.arange(k, device=x.device)
    idx_h = (torch.arange(oh, device=x.device) * s)[:, None] + ar_k[None, :]
    idx_w = (torch.arange(ow, device=x.device) * s)[:, None] + ar_k[None, :]
    rows = xp[:, idx_h]                      # (N, OH, K, W', C)
    patches = rows[:, :, :, idx_w]           # (N, OH, K, OW, K, C)
    patches = patches.permute(0, 1, 3, 2, 4, 5)  # (N, OH, OW, K, K, C)
    return patches.reshape(n, oh, ow, k * k * c)


def matmul_int(x_codes: torch.Tensor, w_codes: torch.Tensor) -> torch.Tensor:
    """Bare integer-code matmul: int32 accumulate, int32 out."""
    if x_codes.is_cuda:
        acc = torch.matmul(x_codes.to(torch.float64), w_codes.to(torch.float64))
        return acc.to(torch.int32)
    return torch.matmul(x_codes.to(torch.int32), w_codes.to(torch.int32))


def mvau_int(x_codes: torch.Tensor, w_codes: torch.Tensor,
             thresholds_int: torch.Tensor, out_base: int = 0) -> torch.Tensor:
    """Integer-domain MVAU: integer codes, int32 accumulate, int thresholds."""
    acc = matmul_int(x_codes, w_codes)
    counts = quant.threshold_counts(acc, thresholds_int)
    return (out_base + counts).to(torch.int32)


# --------------------------------------------------------------------------
# Fast integer paths — bit-identical to the versions above, chosen by the
# deploy-time dispatch (kernels/ops.py) from static node attrs.
# --------------------------------------------------------------------------
def matmul_int_fast(x_codes: torch.Tensor, w_codes: torch.Tensor,
                    acc_f32_exact: bool = False) -> torch.Tensor:
    """Integer-code matmul through the f32 GEMM when the lowering proved
    every partial sum fits ±2**24 (``acc_f32_exact``): every intermediate is
    then an integer exactly representable in float32, so the truncating
    cast back to int32 is the identity on the true sum."""
    if acc_f32_exact:
        return _f32_matmul(x_codes, w_codes).to(torch.int32)
    return matmul_int(x_codes, w_codes)


def _counts_unrolled(acc: torch.Tensor, thresholds: torch.Tensor) -> torch.Tensor:
    """Per-level unrolled compare-count: L adds of a (..., N) compare."""
    counts = torch.zeros(acc.shape, dtype=torch.int32, device=acc.device)
    for level in range(thresholds.shape[-1]):
        counts += (acc >= thresholds[..., level]).to(torch.int32)
    return counts


_UNROLL_MAX_LEVELS = 64   # above this, sorted tables binary-search instead


def threshold_counts_fast(acc: torch.Tensor, thresholds_int: torch.Tensor,
                          sorted_levels=None) -> torch.Tensor:
    """``Σᵢ 1[acc ≥ Tᵢ]``: unrolled below 64 levels, else
    :func:`quant.threshold_counts` (binary search on sorted tables;
    ``sorted_levels`` as there)."""
    if thresholds_int.shape[-1] < _UNROLL_MAX_LEVELS:
        return _counts_unrolled(acc, thresholds_int.to(acc.device))
    return quant.threshold_counts(acc, thresholds_int, sorted_levels)


def count_sorted_steps(acc: torch.Tensor, thresholds: torch.Tensor
                       ) -> torch.Tensor:
    """``Σᵢ 1[acc ≥ Tᵢ]`` over (M, N) int32 accumulators and (N, L) tables
    sorted ascending, by the step arithmetic of ``csrc/mvau.cu``'s
    ``count_sorted_smem`` (the small-M kernel's search, and the lockstep
    search of ``mvau_conv_kernel``'s epilogue), for tests to hold
    against the dense count: the answer lies in [lo, lo + n), n = L + 1
    at the start; a step probes T[lo + h - 1], h = n // 2, adds h to lo
    where acc reaches it, and keeps n - h candidates either way, so every
    search takes ceil(log2(L + 1)) steps.  Nothing on the card's path
    calls this."""
    m = acc.shape[0]
    t = thresholds.to(acc.device).to(torch.int32)
    lo = torch.zeros(acc.shape, dtype=torch.int64, device=acc.device)
    n = t.shape[-1] + 1
    rows = t.unsqueeze(0).expand(m, *t.shape)
    while n > 1:
        h = n // 2
        probe = torch.gather(rows, 2, (lo + h - 1).unsqueeze(-1)).squeeze(-1)
        lo = lo + torch.where(acc >= probe, h, 0)
        n -= h
    return lo.to(torch.int32)


def mvau_int_fast(x_codes: torch.Tensor, w_codes: torch.Tensor,
                  thresholds_int: torch.Tensor, out_base: int = 0,
                  acc_f32_exact: bool = False) -> torch.Tensor:
    """Fused integer MVAU via the fast GEMM + fast threshold count;
    bit-for-bit equal to :func:`mvau_int`."""
    acc = matmul_int_fast(x_codes, w_codes, acc_f32_exact)
    counts = threshold_counts_fast(acc, thresholds_int)
    return (out_base + counts).to(torch.int32)


def multithreshold_int(x_codes: torch.Tensor, thresholds_int: torch.Tensor,
                       out_base: int = 0) -> torch.Tensor:
    """Integer-domain MultiThreshold: ``base + Σᵢ 1[x ≥ Tᵢ]`` over int32
    codes with an int32 threshold table (scales already folded in)."""
    counts = quant.threshold_counts(x_codes.to(torch.int32), thresholds_int)
    return (out_base + counts).to(torch.int32)


def requantize(q: torch.Tensor, shift: int, bits: int, frac_bits: int,
               signed: bool = True) -> torch.Tensor:
    """Exact integer regrid: codes at scale ``2**-f1`` → codes at
    ``2**-(f1+shift)``, round-half-even, saturating.

    Downshifts split ``q = (q >> k) * 2**k + r`` and round the remainder to
    even; upshifts pre-clip so the left shift can never overflow int32.
    """
    spec = quant.FixedPointSpec(bits, frac_bits, signed)
    q = q.to(torch.int32)
    if shift >= 0:
        hi_pre = spec.qmax >> shift
        lo_pre = -((-spec.qmin) >> shift)
        q = torch.clamp(q, lo_pre - 1, hi_pre + 1) << shift
        return torch.clamp(q, spec.qmin, spec.qmax)
    k = -shift
    q2 = q >> k                          # arithmetic shift: floor(q / 2**k)
    r = q - (q2 << k)                    # remainder in [0, 2**k)
    half = 1 << (k - 1)
    up = (r > half) | ((r == half) & ((q2 & 1) == 1))
    q2 = q2 + up.to(torch.int32)
    return torch.clamp(q2, spec.qmin, spec.qmax)


def qmatmul(x: torch.Tensor, w_codes: torch.Tensor, scale: torch.Tensor,
            bits: int = 8) -> torch.Tensor:
    """Weight-only quantized matmul: ``x @ (codes * scale)``.

    x: (..., K) bf16/f32; w_codes: int8 (K, N) for bits==8 or packed int4
    (K, N//2) for bits==4; scale: per-output-channel (N,) or scalar.
    Activations are consumed at bf16 (the tensor cores' input precision);
    codes are exact in bf16 (|code| <= 128).  Accumulation is float32, the
    scale multiplies the accumulator once, and the result has x's dtype.
    """
    if bits == 4:
        w_int = quant.unpack_int4(w_codes)
    elif bits == 8:
        w_int = w_codes.to(torch.int32)
    else:
        raise ValueError(f"unsupported weight bits {bits}")
    x16 = x.to(torch.bfloat16).to(torch.float32)
    acc = _f32_matmul(x16, w_int.to(torch.float32))
    return (acc * scale).to(x.dtype)


def gap(x: torch.Tensor) -> torch.Tensor:
    """GlobalAccPool: spatial **sum** (N,H,W,C) -> (N,C); no division
    (paper Sec. III-D).  Integer inputs accumulate in int32 and come back
    as int32 (``torch.sum`` of int32 alone would return int64)."""
    if not x.dtype.is_floating_point:
        return torch.sum(x.to(torch.int32), dim=(1, 2)).to(torch.int32)
    return torch.sum(x.to(torch.float32), dim=(1, 2))


# ---------------------------------------------------------------------------
# Decode-workload attention: one definition shared by the graph interpreter,
# the compiled DeployedModel and models.lm.decode_step_ref, so "bit for bit
# with the interpreter" is a property of the code.  All math is float32, no
# GQA broadcast (callers require n_kv_heads == n_heads).
#
# The two contractions are a broadcast product summed by halving
# (:func:`_halving_sum`): elementwise adds in a fixed pairwise order.  A
# batched GEMM (``torch.einsum``) may pick another kernel, hence another
# summation order, for another batch size, and the serving contract is that
# a sequence's logits do not depend on the bucket it is padded into.
# ---------------------------------------------------------------------------
def _halving_sum(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Sum over ``dim`` as a fixed tree of elementwise adds: the upper half
    is added onto the lower half (an odd last slice onto the first) until
    one slice is left.  Each output element's order of additions depends
    only on the length of ``dim``, on any device and at any batch size."""
    x = torch.movedim(x, dim, -1)
    while x.shape[-1] > 1:
        n = x.shape[-1]
        h = n // 2
        y = x[..., :h] + x[..., h:2 * h]
        if n % 2:
            y = torch.cat([y[..., :1] + x[..., 2 * h:], y[..., 1:]], dim=-1)
        x = y
    return x[..., 0]


def attn_decode(q: torch.Tensor, k_new: torch.Tensor, v_new: torch.Tensor,
                k_cache: torch.Tensor, v_cache: torch.Tensor,
                pos: torch.Tensor, heads: int):
    """One causal decode step over a fixed-capacity KV cache.

    q/k_new/v_new: (B, D) float32 projections of the current token;
    k_cache/v_cache: (B, C, D) with positions ``< pos`` filled; pos: (B,)
    int32 write/read position per row.  Returns ``(out (B, D), k_cache',
    v_cache')`` with the new K/V written at ``pos`` (a new tensor: the
    serving layer owns cache storage)."""
    B, D = q.shape
    C = k_cache.shape[1]
    hd = D // heads
    ar = torch.arange(C, dtype=torch.int32, device=q.device)
    slot = ar[None, :] == pos.to(torch.int32)[:, None]              # (B, C)
    kc = torch.where(slot[..., None], k_new[:, None, :].to(k_cache.dtype),
                     k_cache)
    vc = torch.where(slot[..., None], v_new[:, None, :].to(v_cache.dtype),
                     v_cache)
    qh = q.to(torch.float32).reshape(B, 1, heads, hd)
    kh = kc.to(torch.float32).reshape(B, C, heads, hd)
    vh = vc.to(torch.float32).reshape(B, C, heads, hd)
    s = _halving_sum(qh * kh, -1).transpose(1, 2) / math.sqrt(hd)  # (B,H,C)
    live = ar[None, None, :] <= pos.to(torch.int32)[:, None, None]
    s = torch.where(live, s, -math.inf)
    w = torch.softmax(s, dim=-1)
    out = _halving_sum(w.transpose(1, 2)[..., None] * vh, 1)       # (B,H,hd)
    return out.reshape(B, D).to(q.dtype), kc, vc


def attn_prefill(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 heads: int) -> torch.Tensor:
    """Causal self-attention over a whole prompt: q/k/v (B, S, D) float32."""
    B, S, D = q.shape
    hd = D // heads
    qh = q.to(torch.float32).reshape(B, S, 1, heads, hd)
    kh = k.to(torch.float32).reshape(B, 1, S, heads, hd)
    vh = v.to(torch.float32).reshape(B, 1, S, heads, hd)
    s = _halving_sum(qh * kh, -1).permute(0, 3, 1, 2) / math.sqrt(hd)
    ar = torch.arange(S, dtype=torch.int32, device=q.device)
    causal = ar[None, :] <= ar[:, None]                     # (q, k)
    s = torch.where(causal[None, None], s, -math.inf)       # (B, H, S, S)
    w = torch.softmax(s, dim=-1)
    out = _halving_sum(w.permute(0, 2, 3, 1)[..., None] * vh, 2)  # (B,S,H,hd)
    return out.reshape(B, S, D).to(q.dtype)
