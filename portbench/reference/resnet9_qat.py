"""Plain reference of the few-shot ResNet-9 on a fixed-point grid.

The QAT forward of the PEFSL / EASY ResNet-9 as the paper trains and
deploys it, written from its description in plain PyTorch: 3x3
convolutions (stride 1, padding 1) on fake-quantized weights, the batch-norm
affine, ReLU, the activation fake-quantized onto its grid, 2x2 max pools,
two residual pairs, global average pooling, and the flip ensemble (the
features of a frame plus those of its mirror image).

Every quantity is worked out here from the parameters and the frames: the
weight codes, the activation grids and their rounding (round half to even,
saturating). Nothing of the system under test is imported or read.

The arithmetic is float64. Codes times power-of-two scales are exact there,
and so is every sum of their products while it stays under 2**53 (a
16-bit weight code times a 17-bit activation code times K = 4,608 terms is
under 2**44), so the features are the exact values of the grid model,
whatever device or summation order computes them.
"""

from __future__ import annotations

import math
from typing import Dict, List

import torch


def plan(width: int) -> List[Dict]:
    """The eight convolutions, in order (PEFSL ResNet-9 of width ``w``)."""
    w = width
    return [
        dict(name="c0", cin=3, cout=w, pool=False),
        dict(name="c1", cin=w, cout=2 * w, pool=True),
        dict(name="r1a", cin=2 * w, cout=2 * w, pool=False, res_open=True),
        dict(name="r1b", cin=2 * w, cout=2 * w, pool=False, res_close=True),
        dict(name="c2", cin=2 * w, cout=4 * w, pool=True),
        dict(name="c3", cin=4 * w, cout=8 * w, pool=True),
        dict(name="r2a", cin=8 * w, cout=8 * w, pool=False, res_open=True),
        dict(name="r2b", cin=8 * w, cout=8 * w, pool=False, res_close=True),
    ]


def init_params(gen: torch.Generator, width: int,
                device: torch.device) -> Dict[str, Dict[str, torch.Tensor]]:
    """He-normal 3x3 kernels ``(3, 3, cin, cout)``; BN gamma a power of two
    per channel, drawn from {0.5, 1, 2}, and beta 0.

    A gamma of its own per channel gives every channel its own threshold
    table, as a trained model's BN does; a power of two keeps the BN affine
    exact, so the grid model stays exact. All kernels come from ONE normal
    draw of ``gen`` on ``device`` (a generator on the card draws there),
    split and scaled per layer, and all gammas from one integer draw."""
    blocks = plan(width)
    sizes = [9 * b["cin"] * b["cout"] for b in blocks]
    flat = torch.randn(sum(sizes), generator=gen, dtype=torch.float32,
                       device=device)
    chans = [b["cout"] for b in blocks]
    expo = torch.randint(-1, 2, (sum(chans),), generator=gen, device=device)
    gammas = torch.pow(2.0, expo.to(torch.float32)).split(chans)
    params, off = {}, 0
    for b, n, g in zip(blocks, sizes, gammas):
        w = flat[off:off + n].view(3, 3, b["cin"], b["cout"])
        off += n
        params[b["name"]] = {
            "w": w * math.sqrt(2.0 / (9 * b["cin"])),
            "gamma": g.contiguous(),
            "beta": torch.zeros(b["cout"], dtype=torch.float32, device=device),
        }
    return params


def fake_quant(x: torch.Tensor, bits: int, frac: int,
               signed: bool) -> torch.Tensor:
    """``x`` rounded half to even onto the grid ``q * 2**-frac`` and
    saturated to ``bits`` (two's complement when ``signed``)."""
    lo, hi = ((-(2 ** (bits - 1)), 2 ** (bits - 1) - 1) if signed
              else (0, 2 ** bits - 1))
    q = torch.clamp(torch.round(x * 2.0 ** frac), lo, hi)
    return q * 2.0 ** -frac


def _conv3x3(h: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """(B, C, H, W) x (3, 3, C, N) -> (B, N, H, W), padding 1, as patches
    times a matrix: a product of float64 matrices, never a transform."""
    n, _, hh, ww = h.shape
    cols = torch.nn.functional.unfold(h, 3, padding=1)       # (B, C*9, HW)
    wm = w.permute(3, 2, 0, 1).reshape(w.shape[3], -1)        # (N, C*9)
    return (wm @ cols).view(n, w.shape[3], hh, ww)


def _backbone(params, x: torch.Tensor, width: int, grid: Dict) -> torch.Tensor:
    wb, wf = grid["weight_bits"], grid["weight_frac"]
    ab, af = grid["act_bits"], grid["act_frac"]
    h = fake_quant(x, ab, af, False).permute(0, 3, 1, 2)      # NCHW
    skip = None
    for b in plan(width):
        p = params[b["name"]]
        w = fake_quant(p["w"].to(torch.float64), wb, wf, True)
        y = _conv3x3(h, w)
        y = (y * p["gamma"].to(torch.float64)[:, None, None]
             + p["beta"].to(torch.float64)[:, None, None])
        y = fake_quant(torch.relu(y), ab, af, False)
        if b.get("pool"):
            y = torch.nn.functional.max_pool2d(y, 2)
        if b.get("res_open"):
            skip = h
        if b.get("res_close"):
            y = y + skip
            skip = None
        h = y
    return h.mean(dim=(2, 3))


def features(params, frames: torch.Tensor, width: int, grid: Dict,
             flip: bool = True, block: int = 64) -> torch.Tensor:
    """(B, H, W, 3) frames -> (B, 8 * width) float64 features on the
    frames' device, ``block`` frames at a time. ``grid`` holds
    ``weight_bits``, ``weight_frac``, ``act_bits`` and ``act_frac``."""
    outs = []
    with torch.no_grad():
        for lo in range(0, frames.shape[0], block):
            x = frames[lo:lo + block].to(torch.float64)
            f = _backbone(params, x, width, grid)
            if flip:
                f = f + _backbone(params, torch.flip(x, dims=[2]), width, grid)
            outs.append(f)
    return torch.cat(outs)
