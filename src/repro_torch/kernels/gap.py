"""GlobalAccPool on the card: wrapper around the hand-written CUDA kernel
(``csrc/gap.cu``) beside its plain PyTorch version.

Counterpart of the JAX package's ``kernels/gap.py`` (``gap_pallas``).  The
kernel optionally takes the residual ``add`` before the pool as a second
operand, so the sum it pools never reaches device memory.  For a CPU tensor
the wrapper takes the plain version; for a CUDA tensor it launches the
kernel or raises.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import build as B
from repro_torch.kernels import ref

__all__ = ["gap", "gap_plain"]

_X_KIND = {torch.int8: 0, torch.uint8: 1, torch.int16: 2, torch.int32: 3,
           torch.float32: 4}


def gap_plain(x: torch.Tensor,
              skip: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain version: (N, H, W, C) -> (N, C) spatial sum of ``x`` (or of
    ``x + skip``), int32 or f32."""
    return ref.gap(x if skip is None else x + skip)


def gap(x: torch.Tensor, skip: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(N, H, W, C) -> (N, C) spatial sum with no division: int32 for
    integer input, float32 for float32 input.  ``skip``, a second operand
    of x's shape, is added first, in the dtype the two promote to (an
    ``add`` node folded into the pool)."""
    if not x.is_cuda:
        return gap_plain(x, skip)
    if x.ndim != 4:
        raise ValueError(f"gap expects (N, H, W, C), got {tuple(x.shape)}")
    if skip is not None:
        if skip.shape != x.shape or skip.device != x.device:
            raise ValueError(f"gap skip {tuple(skip.shape)} on {skip.device} "
                             f"must match x {tuple(x.shape)} on {x.device}")
        dt = torch.promote_types(x.dtype, skip.dtype)
        x, skip = x.to(dt), skip.to(dt)
    if x.dtype not in _X_KIND:
        raise ValueError(f"gap takes int8/uint8/int16/int32/float32, "
                         f"got {x.dtype}")
    if not (x.is_contiguous() and (skip is None or skip.is_contiguous())):
        raise ValueError("gap operands must be contiguous")
    n, h, w, c = x.shape
    out_dtype = torch.float32 if x.dtype == torch.float32 else torch.int32
    out = torch.empty((n, c), dtype=out_dtype, device=x.device)
    rc = B.library().gap(x.data_ptr(),
                         None if skip is None else skip.data_ptr(),
                         _X_KIND[x.dtype], out.data_ptr(), n, h * w, c,
                         torch.cuda.current_stream().cuda_stream)
    B.check(rc, "gap")
    B.count_launch("gap")
    return out
