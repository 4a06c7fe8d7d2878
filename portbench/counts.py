"""The yardstick's frozen arithmetic: operations and bytes of each MVAU,
the H100's peaks, and the union of the device's busy intervals.

An MVAU (matrix-vector-activation unit) is one convolution of the
backbone with its activation quantizer: a product of M patch rows, K taps
and N output channels, then the BN affine, ReLU and the rounding onto the
activation grid. Everything here is a function of the configuration's
shapes and bit-widths alone, never of how the program runs them: a 16-bit
MVAU costs 2*M*K*N operations whether the card does that in one product or
in several byte planes, and its bytes are what the layer must read and
write at the width its codes are stored in.

The quantizer is charged what it must read whatever form it takes: a
scale and an offset per channel. A table of thresholds (L levels a channel,
65,535 at 16 bits) is one way to apply it, and the entries a search of it
reads depend on the data; a bound that charged the whole table would
credit the implementation with bytes the layer does not need.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Tuple

from portbench.reference.resnet9_qat import plan

# One NVIDIA H100 SXM, NVIDIA's data sheet, dense rates at 700 W.
PEAK_INT8_OPS = 1979e12          # int8 tensor-core operations per second
PEAK_HBM_BYTES = 3.35e12         # HBM3 bytes per second
AFFINE_BYTES = 2 * 4             # a channel's scale and offset, 4 bytes each


def code_bytes(bits: int) -> int:
    """Bytes a code of ``bits`` bits is stored in (a byte, two or four)."""
    return 1 if bits <= 8 else 2 if bits <= 16 else 4


def mvau_layers(cfg: Dict) -> List[Dict]:
    """Per frame, every MVAU of a ResNet-9 configuration, in order: its
    ``m`` (output positions), ``k``, ``n`` and the bytes it
    reads and writes: ``a_bytes`` is its quantizer's affine.

    Inputs are the layer's feature map (the patches are the kernel's
    business), at ``act_bits``, or one bit more after a residual sum.
    Outputs are written once, after the pool where the block pools; the
    last block writes the pooled features as float32."""
    ab, wb = cfg["act_bits"], cfg["weight_bits"]
    side = cfg["img"]
    blocks = plan(cfg["width"])
    out = []
    in_bits = ab
    for i, b in enumerate(blocks):
        m, k, n = side * side, 9 * b["cin"], b["cout"]
        out_side = side // 2 if b.get("pool") else side
        last = i == len(blocks) - 1
        out.append({
            "name": b["name"], "m": m, "k": k, "n": n,
            "ops": 2 * m * k * n,
            "in_bytes": side * side * b["cin"] * code_bytes(in_bits),
            "w_bytes": k * n * code_bytes(wb),
            "a_bytes": n * AFFINE_BYTES,
            "out_bytes": n * 4 if last else out_side * out_side * n
            * code_bytes(ab),
        })
        side = out_side
        in_bits = ab + 1 if b.get("res_close") else ab
    return out


def ops_per_frame(cfg: Dict) -> int:
    """Operations of the whole ensemble for one frame: 2*M*K*N of every
    MVAU, twice with the flip ensemble."""
    one = sum(layer["ops"] for layer in mvau_layers(cfg))
    return one * (2 if cfg.get("flip_ensemble", True) else 1)


def mvau_bound_s(cfg: Dict, batch: int) -> float:
    """Least seconds the card could take for the MVAUs of one call of the
    ensemble on ``batch`` frames: per MVAU the larger of its operations over
    the int8 peak and its bytes over HBM's; weights and the quantizer's
    affine are read once a forward, feature maps scale with the batch."""
    total = 0.0
    for layer in mvau_layers(cfg):
        ops = layer["ops"] * batch
        nbytes = ((layer["in_bytes"] + layer["out_bytes"]) * batch
                  + layer["w_bytes"] + layer["a_bytes"])
        total += max(ops / PEAK_INT8_OPS, nbytes / PEAK_HBM_BYTES)
    return total * (2 if cfg.get("flip_ensemble", True) else 1)


def union_seconds(intervals: Iterable[Tuple[float, float]]) -> float:
    """Length of the union of ``(start, end)`` intervals (any unit): time
    in which at least one of them was running, each instant counted once."""
    total = 0.0
    cur_s = cur_e = None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        elif e > cur_e:
            cur_e = e
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def gaps(intervals: Iterable[Tuple[float, float]], lo: float,
         hi: float) -> List[Tuple[float, float]]:
    """The stretches of ``[lo, hi]`` that no interval covers."""
    out, t = [], lo
    for s, e in sorted(intervals):
        if s > t:
            out.append((t, min(s, hi)))
        t = max(t, e)
        if t >= hi:
            break
    if t < hi:
        out.append((t, hi))
    return [(s, e) for s, e in out if e > s]
