"""Arbitrary fixed-point quantization — the grid everything in the port
stands on (PyTorch counterpart of the JAX package's ``core/quant.py``).

The paper (FINN flow, Sec. III) trains at an exact ``(total_bits,
int_bits, frac_bits)`` fixed-point grid and deploys the *same* grid on
hardware.  The QAT forward, the graph interpreter, the compiled artifact
and the CUDA kernels all quantize through the functions here.

Conventions (the paper's Table II notation):

* ``FixedPointSpec(total_bits=6, frac_bits=5)`` is "6 bits (1 bit for the
  integer part and 5 bits for the fractional part)".  ``int_bits =
  total_bits - frac_bits`` and, for signed specs, includes the sign bit.
* The representable grid is ``q * 2**-frac_bits`` for integer ``q`` in
  ``[qmin, qmax]`` — signed: ``[-2**(t-1), 2**(t-1)-1]``, unsigned:
  ``[0, 2**t - 1]``.
* Rounding is round-half-to-even (``torch.round``), clipping saturates.
  ``quantize`` multiplies by ``1.0 / scale`` (it does not divide), so its
  bits equal the JAX package's on every input.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
from typing import Dict, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

__all__ = [
    "FixedPointSpec",
    "LayerQuantPlan",
    "QuantConfig",
    "quantize",
    "dequantize",
    "fake_quant",
    "thresholds_for",
    "multithreshold",
    "threshold_counts",
    "pack_int4",
    "unpack_int4",
    "storage_dtype",
    "storage_bytes_per_element",
]


@dataclasses.dataclass(frozen=True)
class FixedPointSpec:
    """A fixed-point number format: ``total_bits`` with ``frac_bits`` fraction.

    ``signed`` follows the layer class: weights are signed; post-ReLU
    activations may be unsigned (one extra magnitude bit for free, as in
    FINN's unsigned MultiThreshold outputs).
    """

    total_bits: int
    frac_bits: int
    signed: bool = True

    def __post_init__(self):
        # 64-bit headroom: storage formats stop at 32 bits (storage_dtype
        # raises above that), but *accumulator* specs derived by datatype
        # inference (w_bits + a_bits + ceil(log2 K), core/datatypes.py) can
        # legitimately exceed 32 and still need a representable annotation.
        if not (1 <= self.total_bits <= 64):
            raise ValueError(f"total_bits must be in [1,64], got {self.total_bits}")
        if self.frac_bits < -32 or self.frac_bits > 32:
            raise ValueError(f"unreasonable frac_bits {self.frac_bits}")
        if self.signed and self.total_bits < 2:
            raise ValueError("signed formats need >= 2 bits")

    # ---- grid parameters -------------------------------------------------
    @property
    def int_bits(self) -> int:
        """Integer bits, incl. sign for signed formats (paper's notation)."""
        return self.total_bits - self.frac_bits

    @property
    def scale(self) -> float:
        return float(2.0 ** (-self.frac_bits))

    @property
    def qmin(self) -> int:
        return -(2 ** (self.total_bits - 1)) if self.signed else 0

    @property
    def qmax(self) -> int:
        return 2 ** (self.total_bits - 1) - 1 if self.signed else 2**self.total_bits - 1

    @property
    def num_levels(self) -> int:
        return 2**self.total_bits

    @property
    def min_value(self) -> float:
        return self.qmin * self.scale

    @property
    def max_value(self) -> float:
        return self.qmax * self.scale

    def describe(self) -> str:
        sign = "s" if self.signed else "u"
        return f"fx{sign}{self.total_bits}.{self.frac_bits}"


# Layer-class → spec table, the paper's "bit-width configuration".
# ``None`` for a class means keep floating point (the paper's 16-bit
# "conventional" rows are FixedPointSpec(16, 8)).
@dataclasses.dataclass(frozen=True)
class QuantConfig:
    """Per-layer-class bit-width assignment (paper Table II rows).

    The paper distinguishes convolutional-layer ("Conv.") and activation
    ("ReLU") bit-widths.  We generalize to named classes so transformer
    linears, embeddings and caches can be assigned widths too.
    """

    weight: Optional[FixedPointSpec] = None  # conv / linear weights
    act: Optional[FixedPointSpec] = None  # post-activation tensors
    cache: Optional[FixedPointSpec] = None  # KV / SSM-state storage (serving)
    # Per-layer overrides: ``(layer_name, QuantConfig)`` pairs, sorted by
    # name.  ``layer(name)`` resolves a layer's effective config; layers
    # without an override ride the top-level (uniform) specs.  A tuple (not
    # a dict) keeps the dataclass frozen/hashable so configs stay valid
    # cache-key material.
    layers: Tuple[Tuple[str, "QuantConfig"], ...] = ()

    def layer(self, name: str) -> "QuantConfig":
        """Effective config for a named layer: its override when one exists,
        else this config's uniform specs.  The QAT forward, the graph
        exporter and the DSE sweep all resolve per-layer bit-widths through
        this ONE method, so train-time and compile-time can never disagree
        about what grid a layer runs on."""
        for n, cfg in self.layers:
            if n == name:
                return cfg
        return self

    @staticmethod
    def per_layer(plan: "LayerQuantPlan") -> "QuantConfig":
        """Config from a :class:`LayerQuantPlan` — every named layer gets its
        own ``grid_point`` config; the plan default covers the graph input
        and any unnamed layer."""
        dw, da = plan.default
        base = QuantConfig.grid_point(dw, da)
        return dataclasses.replace(
            base,
            layers=tuple((name, QuantConfig.grid_point(w, a))
                         for name, (w, a) in plan.layers))

    @staticmethod
    def paper_w6a4() -> "QuantConfig":
        """The paper's chosen deployment point: conv 6b(1.5), act 4b(2.2)."""
        return QuantConfig(
            weight=FixedPointSpec(6, 5, signed=True),
            act=FixedPointSpec(4, 2, signed=False),
        )

    @staticmethod
    def grid_point(w_bits: int, a_bits: int) -> "QuantConfig":
        """The sweep's frac-split convention for a (W, A) grid point: signed
        weights keep one integer bit (the sign), unsigned activations keep
        two magnitude bits — ``grid_point(6, 4)`` is exactly the paper's
        6(1.5)/4(2.2) deployment point (== :meth:`paper_w6a4`).  This is the
        single source of truth the DSE sweep (``repro.explore``) and the
        farm's publish step (``FSLPipeline.for_point``) both resolve through,
        so a cached sweep point and its served artifact can never disagree
        about what grid a (W, A) pair means.
        """
        return QuantConfig(
            weight=FixedPointSpec(w_bits, max(w_bits - 1, 0), signed=True),
            act=FixedPointSpec(a_bits, max(a_bits - 2, 0), signed=False))

    @staticmethod
    def paper_w16a16() -> "QuantConfig":
        """The conventional (Tensil-era) 16-bit fixed-point baseline."""
        return QuantConfig(
            weight=FixedPointSpec(16, 8, signed=True),
            act=FixedPointSpec(16, 8, signed=False),
        )

    @staticmethod
    def table2_row(max_bits: int, conv_frac: int, act_frac: int,
                   conv_bits: Optional[int] = None,
                   act_bits: Optional[int] = None) -> "QuantConfig":
        cb = conv_bits if conv_bits is not None else max_bits
        ab = act_bits if act_bits is not None else max_bits
        return QuantConfig(
            weight=FixedPointSpec(cb, conv_frac, signed=True),
            act=FixedPointSpec(ab, act_frac, signed=False),
        )


# --------------------------------------------------------------------------
# Per-layer mixed-precision plans (the DSE search's candidate encoding)
# --------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class LayerQuantPlan:
    """A per-layer ``(W, A)`` bit-width assignment — the mixed-precision
    candidate the DSE search explores.

    Each named layer maps to a ``(w_bits, a_bits)`` pair under the SAME
    ``grid_point`` frac-split convention the uniform sweep uses; ``default``
    covers the graph input and any layer the map omits.  Assignments are
    canonicalized (sorted by name, ints coerced) at construction so two
    plans with the same content are ``==``, hash alike, and serialize to the
    same JSON — the property the farm's content-hash cache keys and the
    per-candidate PRNG streams rely on.
    """

    layers: Tuple[Tuple[str, Tuple[int, int]], ...]
    default: Tuple[int, int] = (8, 8)

    def __post_init__(self):
        pairs = [(str(n), (int(w), int(a))) for n, (w, a) in self.layers]
        names = [n for n, _ in pairs]
        if len(set(names)) != len(names):
            dupes = sorted({n for n in names if names.count(n) > 1})
            raise ValueError(f"duplicate layer assignment(s): {dupes}")
        object.__setattr__(self, "layers", tuple(sorted(pairs)))
        dw, da = self.default
        object.__setattr__(self, "default", (int(dw), int(da)))

    @classmethod
    def from_dict(cls, d: Mapping) -> "LayerQuantPlan":
        """Inverse of :meth:`to_dict` (accepts any insertion order)."""
        return cls(layers=tuple((n, tuple(wa))
                                for n, wa in dict(d["layers"]).items()),
                   default=tuple(d.get("default", (8, 8))))

    @classmethod
    def uniform(cls, w_bits: int, a_bits: int,
                names: Sequence[str] = ()) -> "LayerQuantPlan":
        """The uniform grid point expressed as a plan (search seeding)."""
        wa = (int(w_bits), int(a_bits))
        return cls(layers=tuple((n, wa) for n in names), default=wa)

    def bits_for(self, name: str) -> Tuple[int, int]:
        for n, wa in self.layers:
            if n == name:
                return wa
        return self.default

    def replace_layer(self, name: str, w_bits: int,
                      a_bits: int) -> "LayerQuantPlan":
        pairs = tuple((n, wa) for n, wa in self.layers if n != name)
        return dataclasses.replace(
            self, layers=pairs + ((name, (int(w_bits), int(a_bits))),))

    def quant_config(self) -> QuantConfig:
        return QuantConfig.per_layer(self)

    def to_dict(self) -> Dict:
        """Canonical JSON form — content-key material (sorted, ints only)."""
        return {"default": list(self.default),
                "layers": {n: [w, a] for n, (w, a) in self.layers}}

    def digest(self, length: int = 10) -> str:
        blob = json.dumps(self.to_dict(), sort_keys=True,
                          separators=(",", ":"))
        return hashlib.sha256(blob.encode()).hexdigest()[:length]

    def describe(self) -> str:
        body = ",".join(f"{n}=w{w}a{a}" for n, (w, a) in self.layers)
        return f"mp[{body or 'default'}|w{self.default[0]}a{self.default[1]}]"


# --------------------------------------------------------------------------
# Core quantize / dequantize
# --------------------------------------------------------------------------
def quantize(x: torch.Tensor, spec: FixedPointSpec) -> torch.Tensor:
    """Real → integer grid (int32 codes). Saturating, round-half-even."""
    q = torch.round(x * (1.0 / spec.scale))
    q = torch.clamp(q, spec.qmin, spec.qmax)
    return q.to(torch.int32)


def dequantize(q: torch.Tensor, spec: FixedPointSpec) -> torch.Tensor:
    return q.to(torch.float32) * spec.scale


def fake_quant(x: torch.Tensor, spec: Optional[FixedPointSpec]) -> torch.Tensor:
    """Quantize-dequantize with a straight-through gradient estimator.

    The QAT operator: the forward runs on the exact deployment grid, the
    backward passes the gradient through unchanged inside the representable
    range and zero where the forward clipped (``g · 1[min ≤ x ≤ max]``).
    The value is the reference's ``ste + stop_gradient(qdq - ste)``,
    computed op for op so the bits agree; ``detach`` is the stop-gradient.
    """
    if spec is None:
        return x
    qdq = dequantize(quantize(x, spec), spec).to(x.dtype)
    inside = torch.logical_and(x >= spec.min_value, x <= spec.max_value)
    ste = x * inside.to(x.dtype)
    return ste + (qdq - ste).detach()


# --------------------------------------------------------------------------
# MultiThreshold — FINN's activation-quantization node (paper Sec. III-C)
# --------------------------------------------------------------------------
def thresholds_for(spec: FixedPointSpec) -> np.ndarray:
    """Thresholds T s.t. ``qmin + Σᵢ 1[x ≥ Tᵢ]`` == ``quantize(x, spec)``.

    With round-half-even the exact crossover for level q is the midpoint
    ``(q - 0.5) * scale`` with the tie going to the even side; odd levels
    are nudged one float32 ulp up so a plain ``>=`` reproduces
    ``torch.round`` on the grid midpoints.
    """
    qs = np.arange(spec.qmin + 1, spec.qmax + 1, dtype=np.float64)
    mids = (qs - 0.5) * spec.scale
    # round-half-even: a value exactly at the midpoint (q-0.5)·s rounds to
    # the EVEN of {q-1, q}.  For even q the midpoint belongs to level q, so
    # T_q = mid (a ``>=`` compare includes it); for odd q it belongs to
    # q-1, so T_q sits one float32 ulp above the midpoint.
    odd = (np.abs(qs) % 2) == 1
    mids = np.where(odd, np.nextafter(mids.astype(np.float32),
                                      np.float32(np.inf)).astype(np.float64), mids)
    return mids.astype(np.float32)


def multithreshold(x: torch.Tensor, thresholds: torch.Tensor,
                   out_base: int = 0, out_scale: float = 1.0,
                   out_bias: float = 0.0,
                   sorted_levels: Optional[bool] = None) -> torch.Tensor:
    """``out_scale * (out_base + Σᵢ 1[x ≥ Tᵢ]) + out_bias``.

    ``thresholds`` is either ``(L,)`` (per-tensor) or ``(C, L)``
    (per-channel, with x's trailing dim = C — NHWC canonical form);
    ``sorted_levels`` as in :func:`threshold_counts`.
    """
    if thresholds.ndim == 2 and x.shape[-1] != thresholds.shape[0]:
        raise ValueError(
            f"per-channel thresholds {tuple(thresholds.shape)} vs x "
            f"{tuple(x.shape)}: channel dim must be trailing (NHWC canonical "
            "form)")
    counts = threshold_counts(x, thresholds, sorted_levels).to(torch.float32)
    return (out_scale * (out_base + counts) + out_bias).to(x.dtype)


def threshold_counts(x: torch.Tensor, thresholds: torch.Tensor,
                     sorted_levels: Optional[bool] = None) -> torch.Tensor:
    """``Σᵢ 1[x ≥ Tᵢ]`` over the threshold axis — int32 counts.

    ``thresholds`` is ``(L,)`` or ``(C, L)`` (C = x's trailing dim).  Sorted
    tables with L ≥ 64 are binary-searched (``searchsorted(T, x, right)``
    counts exactly the ``Tᵢ ≤ x``), which keeps 16-bit activation grids
    (L = 65535) tractable; unsorted or short tables take the dense compare.
    ``sorted_levels`` says whether the table is sorted where the caller
    knows it (a graph's constant table, checked once when it is lowered);
    None checks here, which waits for the device.
    """
    if thresholds.ndim not in (1, 2):
        raise ValueError("thresholds must be rank 1 or 2")
    n_levels = thresholds.shape[-1]
    t = thresholds.to(x.device)
    if sorted_levels is None and n_levels >= 64:
        sorted_levels = bool(torch.all(torch.diff(t, dim=-1) >= 0))
    if n_levels >= 64 and sorted_levels:
        t = t.to(x.dtype)
        if t.ndim == 1:
            return torch.searchsorted(t.contiguous(), x.contiguous(),
                                      right=True).to(torch.int32)
        c = x.shape[-1]
        xc = x.reshape(-1, c).transpose(0, 1).contiguous()     # (C, M)
        idx = torch.searchsorted(t.contiguous(), xc, right=True)
        return idx.transpose(0, 1).reshape(x.shape).to(torch.int32)
    cmp = x[..., None] >= t
    return torch.sum(cmp, dim=-1).to(torch.int32)


# --------------------------------------------------------------------------
# Sub-byte storage (narrow bits pay off in device-memory bytes)
# --------------------------------------------------------------------------
def pack_int4(q: torch.Tensor) -> torch.Tensor:
    """Pack int32 codes in [-8, 7] pairwise into int8 (low nibble = even idx).

    The trailing dim must be even.  The MVAU kernel unpacks this layout
    while it loads a weight tile into shared memory.
    """
    if q.shape[-1] % 2:
        raise ValueError("trailing dim must be even to pack int4 pairs")
    lo = (q[..., 0::2] & 0xF).to(torch.uint8)
    hi = (q[..., 1::2] & 0xF).to(torch.uint8)
    return (lo | (hi << 4)).view(torch.int8)


def unpack_int4(packed: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`pack_int4`; returns int32 codes in [-8, 7]."""
    p = packed.to(torch.int32) & 0xFF
    lo = p & 0xF
    hi = (p >> 4) & 0xF
    # sign-extend nibbles
    lo = torch.where(lo >= 8, lo - 16, lo)
    hi = torch.where(hi >= 8, hi - 16, hi)
    out = torch.stack([lo, hi], dim=-1)
    return out.reshape(*packed.shape[:-1], packed.shape[-1] * 2)


def storage_dtype(spec: FixedPointSpec) -> torch.dtype:
    """Narrowest dense dtype holding the codes (int4 packs via pack_int4)."""
    if spec.total_bits <= 8:
        return torch.int8
    if spec.total_bits <= 16:
        return torch.int16
    if spec.total_bits <= 32:
        return torch.int32
    raise ValueError(
        f"no dense storage dtype for {spec.total_bits}-bit codes; specs "
        "wider than 32 bits are accumulator annotations, not storage formats")


def storage_bytes_per_element(spec: Optional[FixedPointSpec],
                              fp_bytes: int = 2) -> float:
    """Effective device-memory bytes/element — the roofline-facing quantity.

    int4-and-below counts at its packed density; fp fallback counts bf16.
    """
    if spec is None:
        return float(fp_bytes)
    if spec.total_bits <= 4:
        return 0.5
    return float(storage_dtype(spec).itemsize)
