"""Device resolution: the card is the default, the CPU only on request.

Every entry point of the port takes ``device=None`` and resolves it here.
``None`` means the first CUDA device; without one the call raises instead
of falling back, so a run that was meant for the card can never quietly
measure the CPU.  ``device="cpu"`` (what the tests pass) runs the plain
PyTorch versions of the kernels.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Optional[Union[str, torch.device]]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` -> ``cuda`` (raises without a CUDA device); else as given."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: repro_torch runs on the card by default; "
                "pass device='cpu' to run the plain PyTorch versions")
        device = "cuda"
    dev = torch.device(device)
    if dev.type == "cuda":
        ieee_f32()
    return dev


def ieee_f32() -> None:
    """Keep every float32 product and every bf16 product's sum on the card
    in full IEEE float32.

    TF32 keeps ten mantissa bits; the integer lowering's ``acc_f32_exact``
    proof and the f32 artifact's bit-exactness against the int artifact
    both assume 24.  PyTorch's matmul default is already off, cuDNN's is on:
    both are set explicitly.  cuBLAS may also reduce the split-K partial
    sums of a bf16 product in bf16, which PyTorch allows by default; XLA
    accumulates bf16 dots in float32, so that is turned off too.
    """
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
