"""MVAU on the card: wrappers around the hand-written CUDA kernel
(``csrc/mvau.cu``), each beside its plain PyTorch version.

Counterpart of the JAX package's ``kernels/mvau.py`` (``mvau_int_pallas``,
``mvau_pallas``); ``mvau_int_conv`` is ``mvau_int_pallas`` with the
``im2col`` before it folded into the kernel's loads.  A wrapper takes the
plain version only for tensors that lie on the CPU; for CUDA tensors it
launches the kernel or raises.  It allocates the output (and any split-K
scratch) with ``torch.empty``, launches on PyTorch's current stream,
checks ``cudaGetLastError`` and counts the launch.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import torch

from repro_torch.core import quant
from repro_torch.kernels import build as B
from repro_torch.kernels import ref

__all__ = ["mvau_int", "mvau_int_conv", "mvau", "mvau_int_plain",
           "mvau_int_conv_plain", "mvau_plain", "tc_splits"]

_X_KIND = {torch.int8: 0, torch.int32: 1}


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(msg)


def _check_2d(name: str, t: torch.Tensor, device: torch.device) -> None:
    _require(t.ndim == 2, f"{name} must be 2-D, got shape {tuple(t.shape)}")
    _require(t.device == device, f"{name} is on {t.device}, expected {device}")
    _require(t.is_contiguous(), f"{name} must be contiguous")


def _stream() -> int:
    return torch.cuda.current_stream().cuda_stream


# ---------------------------------------------------------------------------
# Split K on the tensor-core kernel
# ---------------------------------------------------------------------------
TC_TILE = (128, 128, 64)      # csrc/mvau.cu: block tile M x N x K bytes


def tc_splits(m: int, n: int, k: int, sms: int) -> int:
    """K-splits of one tensor-core launch: 1 where the output tiles cover
    the SMs, else up to two blocks per SM, each split keeping at least 16
    K-tiles (shorter splits lose more to the partial-sum round trip than
    the extra blocks gain: ``tools/probe_mvau_conv.py``'s sweep on the
    H100).  The split changes no bit (integer sums)."""
    bm, bn, bk = TC_TILE
    tiles = -(-m // bm) * -(-n // bn)
    if tiles >= sms:
        return 1
    return max(1, min(-(-k // bk) // 16, (2 * sms) // tiles))


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _split_scratch(m: int, n: int, k: int, dev: torch.device,
                   splits: Optional[int]) -> Tuple[int, Optional[int],
                                                   Optional[int]]:
    """(splits, scratch pointer, counters pointer) for one launch; the
    scratch holds each output tile's and split's 128 x 128 int32 partial
    sums."""
    if splits is None:
        splits = tc_splits(m, n, k, _sm_count(dev.index or 0))
    bm, bn, bk = TC_TILE
    kt = max(1, -(-k // bk))
    splits = max(1, min(int(splits), kt))
    splits = -(-kt // -(-kt // splits))   # as the launcher: no empty split
    if splits == 1:
        return 1, None, None
    tiles = -(-m // bm) * -(-n // bn)
    ws = torch.empty((tiles, splits, bm * bn), dtype=torch.int32, device=dev)
    counts = B.tile_counters(dev, tiles)
    # the caching allocator reuses ws only after this launch on the stream
    return splits, ws.data_ptr(), counts.data_ptr()


# ---------------------------------------------------------------------------
# Integer MVAU (replaces mvau_int_pallas)
# ---------------------------------------------------------------------------
def mvau_int_plain(x: torch.Tensor, w: torch.Tensor, thresholds: torch.Tensor,
                   out_base: int = 0, w_packed: bool = False) -> torch.Tensor:
    """Plain version: ``out_base + Σ_l 1[x @ w ≥ T[n, l]]`` as int32."""
    if w_packed:
        w = quant.unpack_int4(w)
    return ref.mvau_int(x, w, thresholds, out_base=out_base)


def mvau_int(x: torch.Tensor, w: torch.Tensor, thresholds: torch.Tensor,
             out_base: int = 0, w_packed: bool = False) -> torch.Tensor:
    """Fused integer MVAU: (M, K) int8/int32 codes × (K, N) int8/int32 codes
    (or (K, N/2) packed int4 with ``w_packed``) against (N, L) int32
    thresholds -> (M, N) int32 codes.  Each threshold row is sorted
    ascending, as the integer lowering leaves every ``mvau_int`` table: the
    kernel binary-searches tables longer than 64 levels."""
    if not x.is_cuda:
        return mvau_int_plain(x, w, thresholds, out_base, w_packed)
    dev = x.device
    for name, t in (("x", x), ("w", w), ("thresholds", thresholds)):
        _check_2d(name, t, dev)
    _require(x.dtype in _X_KIND, f"x must be int8 or int32, got {x.dtype}")
    m, k = x.shape
    _require(w.shape[0] == k, f"w rows {w.shape[0]} != x cols {k}")
    if w_packed:
        _require(w.dtype == torch.int8, "packed int4 weights must be int8")
        n, w_kind = 2 * w.shape[1], 3
    else:
        _require(w.dtype in (torch.int8, torch.int32),
                 f"w must be int8 or int32, got {w.dtype}")
        n, w_kind = w.shape[1], 0 if w.dtype == torch.int8 else 1
    _require(thresholds.dtype == torch.int32, "thresholds must be int32")
    _require(thresholds.shape[0] == n,
             f"thresholds rows {thresholds.shape[0]} != N {n}")
    out = torch.empty((m, n), dtype=torch.int32, device=dev)
    lib = B.library()
    splits, ws, counts = ((1, None, None) if x.dtype != torch.int8
                          or w_kind == 1 else _split_scratch(m, n, k, dev,
                                                             None))
    rc = lib.mvau_int(x.data_ptr(), _X_KIND[x.dtype], w.data_ptr(), w_kind,
                      thresholds.data_ptr(), out.data_ptr(), m, k, n,
                      thresholds.shape[1], int(out_base), splits, ws, counts,
                      _stream())
    B.check(rc, "mvau_int")
    B.launch_counts["mvau_int"] += 1
    return out


def _conv_dims(x: torch.Tensor, w: torch.Tensor, thresholds: torch.Tensor,
               kernel: int, stride: int, pad: int, w_packed: bool):
    """Checks the conv form's operands, for the kernel and its plain version
    alike; returns (B, H, W, C, OH, OW, N)."""
    _require(x.ndim == 4, f"x must be 4-D NHWC, got shape {tuple(x.shape)}")
    _require(x.dtype in _X_KIND, f"x must be int8 or int32 codes, got "
             f"{x.dtype}")
    _require(w.ndim == 2 and thresholds.ndim == 2,
             "w and thresholds must be 2-D")
    _require(kernel >= 1 and stride >= 1 and pad >= 0,
             f"bad kernel/stride/pad {kernel}/{stride}/{pad}")
    b, h, wd, c = x.shape
    oh = (h + 2 * pad - kernel) // stride + 1
    ow = (wd + 2 * pad - kernel) // stride + 1
    _require(oh >= 1 and ow >= 1,
             f"kernel {kernel} does not fit {h}x{wd} padded by {pad}")
    _require(w.shape[0] == kernel * kernel * c,
             f"w rows {w.shape[0]} != kernel²·C {kernel * kernel * c}")
    if w_packed:
        _require(w.dtype == torch.int8, "packed int4 weights must be int8")
    else:
        _require(w.dtype in (torch.int8, torch.int32),
                 f"w must be int8 or int32, got {w.dtype}")
    n = 2 * w.shape[1] if w_packed else w.shape[1]
    _require(thresholds.dtype == torch.int32, "thresholds must be int32")
    _require(thresholds.shape[0] == n,
             f"thresholds rows {thresholds.shape[0]} != N {n}")
    return b, h, wd, c, oh, ow, n


def mvau_int_conv_plain(x: torch.Tensor, w: torch.Tensor,
                        thresholds: torch.Tensor, kernel: int, stride: int,
                        pad: int, out_base: int = 0,
                        w_packed: bool = False) -> torch.Tensor:
    """Plain version of the conv form: :func:`mvau_int_plain` on the patch
    rows of ``ref.im2col`` -> (B, OH, OW, N) int32."""
    b, _, _, _, oh, ow, n = _conv_dims(x, w, thresholds, kernel, stride, pad,
                                       w_packed)
    patches = ref.im2col(x, kernel, stride, pad)
    y = mvau_int_plain(patches.reshape(b * oh * ow, -1), w, thresholds,
                       out_base, w_packed)
    return y.reshape(b, oh, ow, n)


def mvau_int_conv(x: torch.Tensor, w: torch.Tensor, thresholds: torch.Tensor,
                  kernel: int, stride: int, pad: int, out_base: int = 0,
                  w_packed: bool = False, *,
                  splits: Optional[int] = None) -> torch.Tensor:
    """Conv-form integer MVAU: the ``im2col`` node folded into the kernel.

    (B, H, W, C) int8 NHWC codes × (K, N) int8 codes (or (K, N/2) packed
    int4 with ``w_packed``), K = kernel² · C in patch order (kh, kw, c),
    against (N, L) int32 thresholds sorted ascending -> (B, OH, OW, N) int32
    codes: :func:`mvau_int` on the patch rows, which never exist.  The
    kernel reads the activation itself, zero outside the image.  ``splits``
    overrides the split-K planner (:func:`tc_splits`) for measurement."""
    if not x.is_cuda:
        return mvau_int_conv_plain(x, w, thresholds, kernel, stride, pad,
                                   out_base, w_packed)
    dev = x.device
    kernel, stride, pad = int(kernel), int(stride), int(pad)
    b, h, wd, c, oh, ow, n = _conv_dims(x, w, thresholds, kernel, stride, pad,
                                        w_packed)
    _require(x.dtype == torch.int8, "the conv-form kernel takes int8 codes "
             f"(int32 codes take im2col + mvau_int), got {x.dtype}")
    _require(w.dtype == torch.int8, f"w must be int8, got {w.dtype}")
    for name, t in (("x", x), ("w", w), ("thresholds", thresholds)):
        _require(t.device == dev, f"{name} is on {t.device}, expected {dev}")
        _require(t.is_contiguous(), f"{name} must be contiguous")
    out = torch.empty((b, oh, ow, n), dtype=torch.int32, device=dev)
    splits, ws, counts = _split_scratch(b * oh * ow, n, kernel * kernel * c,
                                        dev, splits)
    rc = B.library().mvau_int_conv(
        x.data_ptr(), w.data_ptr(), 3 if w_packed else 0,
        thresholds.data_ptr(), out.data_ptr(), b, h, wd, c, kernel, stride,
        pad, n, thresholds.shape[1], int(out_base), splits, ws, counts,
        _stream())
    B.check(rc, "mvau_int")
    B.launch_counts["mvau_int"] += 1
    return out


# ---------------------------------------------------------------------------
# Float MVAU (replaces mvau_pallas)
# ---------------------------------------------------------------------------
def mvau_plain(x: torch.Tensor, w: torch.Tensor, thresholds: torch.Tensor,
               out_base: float = 0.0, out_scale: float = 1.0,
               out_bias: float = 0.0) -> torch.Tensor:
    """Plain version: float32 ``out_scale·(out_base + count) + out_bias``;
    int8 × int8 operands accumulate in int32, as ``mvau_pallas`` does."""
    if x.dtype == torch.int8 and w.dtype == torch.int8:
        counts = quant.threshold_counts(ref.matmul_int(x, w), thresholds)
        return out_scale * (out_base + counts.to(torch.float32)) + out_bias
    return ref.mvau(x, w, thresholds, out_base, out_scale, out_bias)


def mvau(x: torch.Tensor, w: torch.Tensor, thresholds: torch.Tensor,
         out_base: float = 0.0, out_scale: float = 1.0,
         out_bias: float = 0.0) -> torch.Tensor:
    """Fused float MVAU: (M, K) × (K, N) float32 against (N, L) float32
    thresholds, or int8 × int8 against int32 thresholds -> (M, N) float32."""
    if not x.is_cuda:
        return mvau_plain(x, w, thresholds, out_base, out_scale, out_bias)
    dev = x.device
    for name, t in (("x", x), ("w", w), ("thresholds", thresholds)):
        _check_2d(name, t, dev)
    m, k = x.shape
    _require(w.shape[0] == k, f"w rows {w.shape[0]} != x cols {k}")
    n = w.shape[1]
    _require(thresholds.shape[0] == n,
             f"thresholds rows {thresholds.shape[0]} != N {n}")
    int_path = x.dtype == torch.int8 and w.dtype == torch.int8
    if int_path:
        _require(thresholds.dtype == torch.int32,
                 "int8 operands need int32 thresholds")
    else:
        _require(x.dtype == torch.float32 and w.dtype == torch.float32
                 and thresholds.dtype == torch.float32,
                 "mvau takes float32 x, w and thresholds (or int8 x, w with "
                 f"int32 thresholds), got {x.dtype}, {w.dtype}, "
                 f"{thresholds.dtype}")
    out = torch.empty((m, n), dtype=torch.float32, device=dev)
    lib = B.library()
    fn = lib.mvau_i8 if int_path else lib.mvau_f32
    rc = fn(x.data_ptr(), w.data_ptr(), thresholds.data_ptr(), out.data_ptr(),
            m, k, n, thresholds.shape[1], float(out_base), float(out_scale),
            float(out_bias), _stream())
    B.check(rc, "mvau")
    B.launch_counts["mvau"] += 1
    return out
