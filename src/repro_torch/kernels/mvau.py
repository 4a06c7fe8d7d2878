"""MVAU on the card: wrappers around the hand-written CUDA kernel
(``csrc/mvau.cu``), each beside its plain PyTorch version.

Counterpart of the JAX package's ``kernels/mvau.py`` (``mvau_int_pallas``,
``mvau_pallas``).  A wrapper takes the plain version only for tensors that
lie on the CPU; for CUDA tensors it launches the kernel or raises.  It
allocates the output with ``torch.empty``, launches on PyTorch's current
stream, checks ``cudaGetLastError`` and counts the launch.
"""

from __future__ import annotations

import torch

from repro_torch.core import quant
from repro_torch.kernels import build as B
from repro_torch.kernels import ref

__all__ = ["mvau_int", "mvau", "mvau_int_plain", "mvau_plain"]

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
    rc = lib.mvau_int(x.data_ptr(), _X_KIND[x.dtype], w.data_ptr(), w_kind,
                      thresholds.data_ptr(), out.data_ptr(), m, k, n,
                      thresholds.shape[1], int(out_base), _stream())
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
