"""Weight-only quantized matmul on the card: the wrapper around the
hand-written CUDA kernel (``csrc/qmatmul.cu``) beside its plain version.

Counterpart of the JAX package's ``kernels/qmatmul.py``
(``qmatmul_pallas``): ``bf16(x) @ codes`` with float32 accumulation, times
a per-output-channel scale, cast to x's dtype; codes are int8 (w8) or
packed int4 (w4, low nibble = even column).  The wrapper takes the plain
version only for tensors that lie on the CPU; for CUDA tensors it launches
the kernel or raises.  It allocates the output (and, when K is split, the
float32 scratch of the splits' sums) with ``torch.empty``, launches on
PyTorch's current stream, checks ``cudaGetLastError`` and counts the
launch.  How the work is cut into blocks (:func:`split_plan`) is decided
here, in Python, so the CPU tests reach it.
"""

from __future__ import annotations

import functools
from typing import Tuple

import torch

from repro_torch.kernels import build as B
from repro_torch.kernels import ref

__all__ = ["qmatmul", "qmatmul_plain", "split_plan"]

BN = 64                # output columns per block (csrc/qmatmul.cu)
MIN_SPLIT_ROWS = 256   # one unrolled sweep of a block's 32 x 8 weight rows
MAX_SPLITS = 64
_X_BF16 = {torch.float32: 0, torch.bfloat16: 1}


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(msg)


def _reject(x, w_codes, scale, bits) -> None:
    """Raise naming the first argument ``qmatmul`` does not take."""
    _require(bits in (4, 8), f"bits must be 4 or 8, got {bits}")
    for name, t, nd in (("x", x, 2), ("w_codes", w_codes, 2),
                        ("scale", scale, 1)):
        _require(t.ndim == nd, f"{name} must be {nd}-D, got shape "
                 f"{tuple(t.shape)}")
        _require(t.device == x.device, f"{name} is on {t.device}, expected "
                 f"{x.device}")
        _require(t.is_contiguous(), f"{name} must be contiguous")
    _require(x.dtype in _X_BF16, f"x must be float32 or bfloat16, got {x.dtype}")
    _require(w_codes.dtype == torch.int8, f"codes must be int8, got "
             f"{w_codes.dtype}")
    _require(scale.dtype == torch.float32, f"scale must be float32, got "
             f"{scale.dtype}")
    _require(w_codes.shape[0] == x.shape[1], f"codes rows {w_codes.shape[0]} "
             f"!= x cols {x.shape[1]}")
    n = w_codes.shape[1] * (2 if bits == 4 else 1)
    raise ValueError(f"scale must be ({n},), got {tuple(scale.shape)}")


def split_plan(m: int, k: int, n: int, sms: int) -> Tuple[int, int, int]:
    """(rows per block, K splits, K rows per split) for an (m, k) x (k, n)
    product on a card with ``sms`` multiprocessors.

    A block takes the smallest of 1, 2, 4 or 8 rows that holds all of a
    decode batch (more rows come in further blocks).  K is split in two
    until the blocks number at least one and a half per SM, while each
    split keeps at least one sweep (256 rows) of K: decode's projections
    with N = 256 or 2048 would otherwise stream their weights through a
    fraction of the SMs.  (Measured on the H100 at the decode shapes: more
    splits than that add more reduce traffic and block start-up than they
    gain.)
    """
    mt = 1 if m <= 1 else 2 if m <= 2 else 4 if m <= 4 else 8
    tiles = -(-n // BN) * -(-m // mt)
    splits = 1
    while (2 * tiles * splits < 3 * sms and splits * 2 <= MAX_SPLITS
           and k >= 2 * splits * MIN_SPLIT_ROWS):
        splits *= 2
    return mt, splits, max(1, -(-k // splits))


@functools.lru_cache(maxsize=None)
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def qmatmul_plain(x: torch.Tensor, w_codes: torch.Tensor,
                  scale: torch.Tensor, bits: int = 8) -> torch.Tensor:
    """Plain version: ``(f32(bf16(x)) @ f32(codes)) * scale`` cast to
    x's dtype."""
    return ref.qmatmul(x, w_codes, scale, bits)


def qmatmul(x: torch.Tensor, w_codes: torch.Tensor, scale: torch.Tensor,
            bits: int = 8) -> torch.Tensor:
    """(M, K) float32/bf16 x (K, N) int8 codes (bits 8) or (K, N/2) packed
    int4 (bits 4), per-channel (N,) float32 scale -> (M, N) of x's dtype."""
    if not x.is_cuda:
        return qmatmul_plain(x, w_codes, scale, bits)
    # one boolean test on the hot path (252 calls per decode step); the
    # messages are built only when it fails
    dev = x.device
    m, k = x.shape if x.ndim == 2 else (-1, -1)
    n = (w_codes.shape[-1] if w_codes.ndim else 0) * (2 if bits == 4 else 1)
    if not (bits in (4, 8) and x.ndim == 2 and w_codes.ndim == 2
            and scale.ndim == 1 and w_codes.device == dev
            and scale.device == dev and x.is_contiguous()
            and w_codes.is_contiguous() and scale.is_contiguous()
            and x.dtype in _X_BF16 and w_codes.dtype == torch.int8
            and scale.dtype == torch.float32 and w_codes.shape[0] == k
            and scale.shape[0] == n):
        _reject(x, w_codes, scale, bits)
    out = torch.empty((m, n), dtype=x.dtype, device=dev)
    if m == 0 or n == 0:
        return out
    mt, splits, kps = split_plan(m, k, n, _sms(dev.index or 0))
    partial = (torch.empty((splits, m, n), dtype=torch.float32, device=dev)
               if splits > 1 else None)
    lib = B.library()
    rc = lib.qmatmul(x.data_ptr(), _X_BF16[x.dtype], w_codes.data_ptr(), bits,
                     scale.data_ptr(), out.data_ptr(),
                     None if partial is None else partial.data_ptr(),
                     m, k, n, mt, splits, kps, _stream())
    B.check(rc, "qmatmul")
    B.launch_counts["qmatmul"] += 1
    return out
