"""GlobalAccPool on the card: wrapper around the hand-written CUDA kernel
(``csrc/gap.cu``) beside its plain PyTorch version.

Counterpart of the JAX package's ``kernels/gap.py`` (``gap_pallas``).  For
a CPU tensor the wrapper takes the plain version; for a CUDA tensor it
launches the kernel or raises.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import build as B
from repro_torch.kernels import ref

__all__ = ["gap", "gap_plain"]

_X_KIND = {torch.int8: 0, torch.uint8: 1, torch.int16: 2, torch.int32: 3,
           torch.float32: 4}


def gap_plain(x: torch.Tensor) -> torch.Tensor:
    """Plain version: (N, H, W, C) -> (N, C) spatial sum, int32 or f32."""
    return ref.gap(x)


def gap(x: torch.Tensor) -> torch.Tensor:
    """(N, H, W, C) -> (N, C) spatial sum with no division: int32 for
    integer input, float32 for float32 input."""
    if not x.is_cuda:
        return gap_plain(x)
    if x.ndim != 4:
        raise ValueError(f"gap expects (N, H, W, C), got {tuple(x.shape)}")
    if x.dtype not in _X_KIND:
        raise ValueError(f"gap takes int8/uint8/int16/int32/float32, "
                         f"got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("gap input must be contiguous")
    n, h, w, c = x.shape
    out_dtype = torch.float32 if x.dtype == torch.float32 else torch.int32
    out = torch.empty((n, c), dtype=out_dtype, device=x.device)
    rc = B.library().gap(x.data_ptr(), _X_KIND[x.dtype], out.data_ptr(),
                         n, h * w, c, torch.cuda.current_stream().cuda_stream)
    B.check(rc, "gap")
    B.launch_counts["gap"] += 1
    return out
