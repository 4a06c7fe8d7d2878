"""ResNet-9 — the paper's few-shot backbone (PEFSL / EASY), quantization-aware.

Counterpart of the JAX package's ``models/resnet9.py``, in the same NHWC
layout with the same explicit im2col (patch order (kh, kw, c)): the paper's
transpose fix exists because of an NCHW export, so a channels-first rewrite
would change the graph under test.  Two execution forms, numerically
identical by construction:

1. **QAT model** (``forward``): im2col+matmul convolutions with
   fake-quantized weights, per-channel BN affine, ReLU, activation
   fake-quant — trainable end-to-end on the exact deployment grid, with the
   straight-through gradient of ``fake_quant`` and a backward free of
   atomics, so training on the card is deterministic.
2. **Exported dataflow graph** (``export_graph``): MatMul nodes with
   quantized weight initializers, BN+ReLU+act-quant folded into per-channel
   **MultiThreshold** nodes, the stray NHWC→NCHW transposes an NCHW export
   inserts (paper Fig. 4), and the final spatial ``reduce_mean``.

Structure (PEFSL ResNet-9, width w): conv(3→w) · conv(w→2w)+pool ·
residual(2w) · conv(2w→4w)+pool · conv(4w→8w)+pool · residual(8w) · GAP.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from repro_torch.core.graph import Graph, Node
from repro_torch.core.quant import QuantConfig, fake_quant, thresholds_for
from repro_torch.device import DeviceLike, ieee_f32, resolve_device

Params = Dict[str, Any]


def plan(width: int = 64) -> List[Dict]:
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


def feature_dim(width: int = 64) -> int:
    return 8 * width


def layer_names(width: int = 64) -> List[str]:
    """Quantizable layer names, in plan order — the per-layer DSE axis."""
    return [blk["name"] for blk in plan(width)]


def coupled_act_groups(width: int = 64) -> List[List[str]]:
    """Layer groups whose ACTIVATION grids must share a fraction: a residual
    add sums the closing block's activation with the tensor that entered
    the residual pair, and is only code-exact on a common fraction."""
    groups: List[List[str]] = []
    entry = prev = None
    for blk in plan(width):
        if blk.get("res_open"):
            entry = prev
        if blk.get("res_close") and entry is not None:
            groups.append([entry, blk["name"]])
            entry = None
        prev = blk["name"]
    return groups


def quant_layers(width: int = 64) -> Dict[str, Any]:
    """The BuildRecipe ``quant_layers`` hook: names + act couplings."""
    return {"names": layer_names(width),
            "coupled_act": coupled_act_groups(width)}


def init_params(gen: torch.Generator, width: int = 64,
                device: DeviceLike = None) -> Params:
    """He-normal conv weights (k, k, cin, cout), BN γ = 1, β = 0.

    The draws come from ``gen`` on its own device (a CPU generator gives the
    same weights whatever ``device`` they land on), then move to ``device``
    (default: the card).  The JAX package's ``jax.random`` streams cannot be
    reproduced here; to compute on the reference's weights, convert them
    with :func:`repro_torch.convert.params_from_numpy`.
    """
    dev = resolve_device(device)
    p: Params = {}
    for blk in plan(width):
        k = 3
        fan_in = k * k * blk["cin"]
        w = torch.randn((k, k, blk["cin"], blk["cout"]), generator=gen,
                        dtype=torch.float32, device=gen.device)
        p[blk["name"]] = {
            "w": (w * math.sqrt(2.0 / fan_in)).to(dev),
            "gamma": torch.ones((blk["cout"],), dtype=torch.float32,
                                device=dev),
            "beta": torch.zeros((blk["cout"],), dtype=torch.float32,
                                device=dev),
        }
    return p


# ---------------------------------------------------------------------------
# im2col conv (shared by model and graph — exact-match guarantee)
# ---------------------------------------------------------------------------
def _im2col(x: torch.Tensor, k: int = 3, stride: int = 1,
            pad: int = 1) -> torch.Tensor:
    """(N, H, W, C) -> (N, OH, OW, k·k·C) patches in (kh, kw, c) order.

    The k·k shifted (strided) slices of the padded input, concatenated
    along channels: the same values as the reference's advanced-index
    gather, and a backward of plain slice adds.  A gather's backward is an
    accumulate-scatter, which runs on atomics on CUDA and sums in a
    different order from run to run."""
    n, h, w, c = x.shape
    xp = torch.nn.functional.pad(x, (0, 0, pad, pad, pad, pad))
    oh = (h + 2 * pad - k) // stride + 1
    ow = (w + 2 * pad - k) // stride + 1
    cols = [xp[:, i:i + (oh - 1) * stride + 1:stride,
               j:j + (ow - 1) * stride + 1:stride]
            for i in range(k) for j in range(k)]
    return torch.cat(cols, dim=-1)


def _maxpool(x: torch.Tensor, k: int = 2) -> torch.Tensor:
    """k×k max pool.  ``amax`` splits the gradient evenly between tied
    maxima, as JAX's reduce-max does (``max_pool2d`` routes it to one)."""
    n, h, w, c = x.shape
    return torch.amax(x.reshape(n, h // k, k, w // k, k, c), dim=(2, 4))


def forward(params: Params, x: torch.Tensor,
            qcfg: Optional[QuantConfig] = None,
            width: int = 64) -> torch.Tensor:
    """x: (B, H, W, 3) NHWC in [0,1]-ish. Returns (B, 8·width) features.

    Each block resolves its own specs through ``qcfg.layer(name)``; the
    graph input rides the TOP-LEVEL activation grid.  Differentiable in
    every leaf of ``params`` (``w``, ``gamma``, ``beta``).
    """
    if x.is_cuda:
        ieee_f32()
    as_in = qcfg.act if qcfg else None
    x = fake_quant(x, as_in)
    skip = None
    for blk in plan(width):
        p = params[blk["name"]]
        lcfg = qcfg.layer(blk["name"]) if qcfg else None
        ws = lcfg.weight if lcfg else None
        as_ = lcfg.act if lcfg else None
        w_q = fake_quant(p["w"], ws).reshape(-1, blk["cout"])
        y = torch.matmul(_im2col(x), w_q)                 # conv as im2col·W
        y = y * p["gamma"] + p["beta"]                    # BN affine (folded)
        y = torch.relu(y)
        y = fake_quant(y, as_)
        if blk.get("pool"):
            y = _maxpool(y)
        if blk.get("res_open"):
            skip = x
        if blk.get("res_close"):
            y = y + skip
            skip = None
        x = y
    return torch.mean(x, dim=(1, 2))                      # -> GAP in export


# float32 roundings of slack on each side of a grid midpoint: the export's
# quotient, and QAT's product and sum, round once each
TIE_ULPS = 4


def midpoint_ties(params: Params, x: torch.Tensor, qcfg: QuantConfig,
                  width: int = 64) -> torch.Tensor:
    """Per frame of ``x``, how many pre-activations ``γ·y + β`` of the QAT
    forward lie within ``TIE_ULPS`` float32 roundings of an activation-grid
    midpoint ``(k + ½)·scale``.

    The export folds BN + ReLU + act-quant into ``y ≥ (T − β)/γ`` with the
    quotient rounded to float32; the QAT forward rounds ``γ·y + β`` to
    float32 and then to the grid.  Both are exact up to those roundings,
    so they can code a pre-activation differently only inside this band
    (trained BN parameters reach it; γ = 1, β = 0 never do).  The test
    reads the grid and the BN parameters, never the exported thresholds,
    so a wrong threshold export shows as a mismatch on an untied frame.
    The band is ``TIE_ULPS · 2⁻²⁴ · (|γ·y| + |β| + |mid|)``, in float64
    from the float32 product ``y``, which is exact while the codes'
    products sum within 24 bits (``paper_w6a4()`` at width 64 does).  Returns (B,)
    int64 counts; runs the QAT forward, without gradients.
    """
    counts = torch.zeros(x.shape[0], dtype=torch.int64, device=x.device)
    with torch.no_grad():
        h = fake_quant(x, qcfg.act)
        skip = None
        for blk in plan(width):
            p = params[blk["name"]]
            act = qcfg.layer(blk["name"]).act
            w_q = fake_quant(p["w"], qcfg.layer(blk["name"]).weight)
            y = torch.matmul(_im2col(h), w_q.reshape(-1, blk["cout"]))
            gy = y.double() * p["gamma"].double()
            z = gy + p["beta"].double()
            k = torch.floor(z / act.scale)
            mid = (k + 0.5) * act.scale
            band = TIE_ULPS * 2.0 ** -24 * (gy.abs() + p["beta"].double().abs()
                                        + mid.abs())
            tie = (((z - mid).abs() <= band) & (k >= max(act.qmin, 0))
                   & (k < act.qmax))
            counts += tie.reshape(x.shape[0], -1).sum(dim=1)
            a = fake_quant(torch.relu(y * p["gamma"] + p["beta"]), act)
            if blk.get("pool"):
                a = _maxpool(a)
            if blk.get("res_open"):
                skip = h
            if blk.get("res_close"):
                a = a + skip
                skip = None
            h = a
    return counts


# ---------------------------------------------------------------------------
# FINN-style export (paper Fig. 3 flow: Brevitas/ONNX -> graph)
# ---------------------------------------------------------------------------
def _numpy(t: Any, dtype=None) -> np.ndarray:
    a = t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)
    return a if dtype is None else a.astype(dtype)


def _block_thresholds(p: Params, aspec) -> np.ndarray:
    """Fold BN affine + ReLU + act-quant into per-channel thresholds:
    code q fires when γ·y + β ≥ T_q^grid, i.e. y ≥ (T_q^grid − β)/γ.
    Computed in float64, then cast to float32, as the reference does.
    Requires γ > 0."""
    grid = thresholds_for(aspec)                          # (L,)
    gamma = _numpy(p["gamma"], np.float64)
    beta = _numpy(p["beta"], np.float64)
    if not (gamma > 0).all():
        raise ValueError("BN scale must stay positive for threshold folding")
    t = (grid[None, :] - beta[:, None]) / gamma[:, None]  # (C, L)
    return t.astype(np.float32)


def export_graph(params: Params, qcfg: QuantConfig, width: int = 64,
                 img: int = 32, insert_transposes: bool = True) -> Graph:
    """Produce the pre-streamline dataflow graph.

    ``insert_transposes=True`` reproduces the NCHW-export artifact the paper
    fixes: a Transpose(NHWC→NCHW) lands between each conv-MatMul and its
    MultiThreshold, and Transpose(NCHW→NHWC) follows (Fig. 4).  The
    streamline pipeline must absorb/cancel them all.
    """
    nodes: List[Node] = []
    inits: Dict[str, np.ndarray] = {}
    src = "x"  # NHWC, already on the activation grid
    hw = img
    skip_src = None

    for blk in plan(width):
        nm = blk["name"]
        p = params[blk["name"]]
        lcfg = qcfg.layer(nm)                 # per-layer specs (self if uniform)
        ws, as_ = lcfg.weight, lcfg.act
        w_q = _numpy(fake_quant(torch.as_tensor(p["w"]), ws)).reshape(
            -1, blk["cout"])
        inits[f"{nm}_w"] = w_q.astype(np.float32)
        inits[f"{nm}_t"] = _block_thresholds(p, as_)

        nodes.append(Node("im2col", [src], [f"{nm}_col"],
                          {"kernel": 3, "stride": 1, "pad": 1}))
        nodes.append(Node("matmul", [f"{nm}_col", f"{nm}_w"], [f"{nm}_mm"]))
        mm_out = f"{nm}_mm"
        if insert_transposes:
            nodes.append(Node("transpose", [mm_out], [f"{nm}_nchw"],
                              {"perm": [0, 3, 1, 2]}))
            nodes.append(Node("multithreshold", [f"{nm}_nchw", f"{nm}_t"],
                              [f"{nm}_mt_nchw"],
                              {"channel_axis": 1, "out_base": 0,
                               "out_scale": as_.scale}))
            nodes.append(Node("transpose", [f"{nm}_mt_nchw"], [f"{nm}_act"],
                              {"perm": [0, 2, 3, 1]}))
        else:
            nodes.append(Node("multithreshold", [mm_out, f"{nm}_t"],
                              [f"{nm}_act"],
                              {"channel_axis": -1, "out_base": 0,
                               "out_scale": as_.scale}))
        cur = f"{nm}_act"
        if blk.get("pool"):
            nodes.append(Node("maxpool", [cur], [f"{nm}_pool"], {"kernel": 2}))
            cur = f"{nm}_pool"
            hw //= 2
        if blk.get("res_open"):
            skip_src = src
        if blk.get("res_close"):
            nodes.append(Node("add", [cur, skip_src], [f"{nm}_res"]))
            cur = f"{nm}_res"
            skip_src = None
        src = cur

    nodes.append(Node("reduce_mean", [src], ["features"],
                      {"axes": [1, 2], "spatial_size": hw * hw}))
    g = Graph(nodes, ["x"], ["features"], inits, name="resnet9")
    # Datatype seeds for InferDataTypes: the input rides the activation
    # grid, weight initializers the weight grid; threshold tables are float
    # compile-time constants until integer lowering.
    g.dtypes["x"] = qcfg.act
    for blk in plan(width):
        g.dtypes[f"{blk['name']}_w"] = qcfg.layer(blk["name"]).weight
        g.dtypes[f"{blk['name']}_t"] = None
    return g


# ---------------------------------------------------------------------------
# Build recipe — registered HERE so new backbones plug into compile()
# without touching repro_torch/core (paper Sec. III-A: step lists belong to
# the architecture, not the framework).
# ---------------------------------------------------------------------------
def _export_for_compile(params: Params, qcfg: QuantConfig,
                        img: int = 32) -> Graph:
    """Recipe exporter: infer width from the param tree, export the graph."""
    if qcfg is None:
        raise ValueError("compile(resnet9_params, qcfg): qcfg is required to "
                         "place thresholds on the bit-width grid")
    width = int(params["c0"]["w"].shape[-1])
    return export_graph(params, qcfg, width=width, img=img)


def _register_recipe():
    from repro_torch.core.recipes import register_recipe

    register_recipe(
        "resnet9",
        ["convert_reduce_mean_to_gap",
         "absorb_transpose_into_multithreshold",
         "cancel_transpose_pairs",
         "move_mul_past_matmul",
         "collapse_repeated_mul",
         "fold_mul_into_multithreshold",
         "fuse_matmul_threshold_to_mvau",
         "verify_hw_mappable"],
        description="paper's customized ResNet-9 flow (Sec. III-C/D fixes)",
        exporter=_export_for_compile,
        init_params=init_params,
        feature_dim=feature_dim,
        forward=forward,
        quant_layers=quant_layers)


_register_recipe()
