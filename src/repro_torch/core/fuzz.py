"""Differential fuzzing of the port's compiler, lowering and kernels.

Random small hardware-mapped graphs -- conv blocks (``im2col -> mvau``, or
``im2col -> matmul -> multithreshold``), maxpools, a bare-matmul head, a
residual ``add`` and a GlobalAccPool tail over random ``FixedPointSpec``
grids -- must give the same bits through four engines::

    interpreter (graph.execute)
      == f32 artifact          (compile(..., datapath="f32"))
      == unfused int artifact  (datapath="int", fuse=False)
      == fused int artifact    (datapath="int")

Two corpora:

* :func:`random_hw_graph` -- the JAX package's own generator
  (``tests/test_differential.py``), draw for draw: the same seed gives the
  same graph, initializers and input bit for bit.  Its shapes are small (N
  1-4, K 9-36).
* :func:`wide_hw_graph` -- the same node kinds and conventions on a seed
  stream of its own, with shapes that reach the edges of the card's kernel
  tiles: M past 128 rows with a ragged last tile, N past 128 columns, K
  deep enough to split, 8-bit activations (255-level, binary-searched
  tables, the plane route) beside narrower ones (the int8 ``wgmma``
  route), and residual blocks whose ``add`` lowers to integers (a fused
  GAP tail or the GAP kernel with a skip operand) or stays float.

:func:`check_differential` runs the four engines on one device and holds
them equal; on the card it is what ``chip_smoke.py``'s ``fuzz`` phase
runs, and the CPU tests hold its outputs against the JAX interpreter.
This module imports numpy and the port only.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import numpy as np
import torch

from repro_torch.core.graph import Graph, Node, execute
from repro_torch.core.quant import FixedPointSpec, fake_quant, thresholds_for
from repro_torch.core.recipes import BuildRecipe
from repro_torch.device import DeviceLike, resolve_device

__all__ = ["FUZZ_RECIPE", "FuzzMismatch", "random_hw_graph", "wide_hw_graph",
           "gemm_hw_graph", "check_differential", "same_output",
           "lowering_summary", "REFERENCE_SEEDS", "WIDE_SEEDS", "GEMM_SEEDS",
           "GEMM_ROWS", "GEMM_DEPTHS", "WIDE_CHANNELS", "WIDE_IMAGES",
           "H100_SMS"]

# Graphs are generated pre-streamlined (already HW-mapped): the recipe is
# the empty pass list, so compile() only appends the datatype-inference and
# integer-lowering passes for datapath="int".
FUZZ_RECIPE = BuildRecipe(
    "differential-fuzz", (),
    description="empty pass list over pre-HW-mapped random graphs")

# every partial sum of a float product or pool on the grid must stay an
# exact float32 integer multiple of its finest step: the four engines sum
# in different orders
F32_EXACT = 2 ** 24

WIDE_CHANNELS = (1, 2, 3, 4, 5, 6, 7, 8, 63, 64, 65, 127, 128, 129, 160)
WIDE_IMAGES = (4, 5, 8, 11, 17)
# the wide corpus's own seed stream: np.random.default_rng((WIDE_STREAM, s))
WIDE_STREAM = 0x51DE
# the dense corpus's rows, depths and seed stream: decode and small-batch
# GEMM shapes on both sides of the int8 GEMM form's route limit
GEMM_ROWS = (1, 2, 3, 5, 8, 13, 16, 31, 33, 63, 64, 65, 100, 128, 129, 255,
             256, 257, 511, 513, 1000, 2049)
GEMM_DEPTHS = (1, 4, 17, 63, 64, 96, 129, 255, 256, 511, 1024, 1440)
GEMM_STREAM = 0x6E33
# the seeds the card runs (chip_smoke.py's fuzz phase); the CPU tests check
# that the wide and dense ranges reach every route and tile edge listed
# above
REFERENCE_SEEDS = range(158)
WIDE_SEEDS = range(256)
GEMM_SEEDS = range(96)
# streaming multiprocessors of an H100 SXM: what the kernels' K-split
# planner sees there (kernels.mvau.tc_splits / core_splits)
H100_SMS = 132


class FuzzMismatch(AssertionError):
    """An engine disagreed, or an artifact lost the structure it must keep."""


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise FuzzMismatch(msg)


def _fq(a: np.ndarray, spec: FixedPointSpec) -> np.ndarray:
    """``fake_quant`` of a float32 numpy array -> float32 numpy."""
    return fake_quant(torch.from_numpy(a), spec).numpy()


# ---------------------------------------------------------------------------
# The reference's generator, draw for draw
# ---------------------------------------------------------------------------
def _rand_act_spec(rng, max_bits: int = 5) -> FixedPointSpec:
    bits = int(rng.integers(2, max_bits + 1))
    return FixedPointSpec(bits, int(rng.integers(0, bits + 1)), signed=False)


def _rand_weight_spec(rng) -> FixedPointSpec:
    bits = int(rng.integers(2, 7))
    return FixedPointSpec(bits, int(rng.integers(0, bits)), signed=True)


def _rand_thresholds(rng, aspec: FixedPointSpec, cout: int) -> np.ndarray:
    """Activation-grid thresholds, randomly per-tensor (L,) or per-channel
    (C, L) through a random positive affine (the BN-folding shape)."""
    grid = thresholds_for(aspec)                      # (L,) ascending
    if rng.random() < 0.3:
        return grid.copy()
    gamma = np.exp(rng.normal(scale=0.5, size=(cout, 1)))
    beta = rng.normal(scale=0.3, size=(cout, 1))
    return ((grid[None, :] - beta) / gamma).astype(np.float32)


def _block(nodes, inits, dtypes, b, src, w, t, wspec, aspec, fused,
           kernel) -> str:
    """Append conv block ``b`` (im2col, then an mvau or a matmul and a
    standalone multithreshold) reading ``src``; returns its output.  With
    ``kernel`` None the block is a dense layer on (M, K) ``src``: no
    im2col."""
    inits[f"b{b}_w"] = w
    inits[f"b{b}_t"] = t
    dtypes[f"b{b}_w"] = wspec
    dtypes[f"b{b}_t"] = None
    col = src
    if kernel is not None:
        col = f"b{b}_col"
        nodes.append(Node("im2col", [src], [col],
                          {"kernel": kernel, "stride": 1,
                           "pad": kernel // 2}))
    if fused:
        nodes.append(Node("mvau", [col, f"b{b}_w", f"b{b}_t"],
                          [f"b{b}_act"],
                          {"out_base": 0, "out_scale": aspec.scale}))
    else:
        nodes.append(Node("matmul", [col, f"b{b}_w"], [f"b{b}_mm"]))
        nodes.append(Node("multithreshold", [f"b{b}_mm", f"b{b}_t"],
                          [f"b{b}_act"],
                          {"channel_axis": -1, "out_base": 0,
                           "out_scale": aspec.scale}))
    return f"b{b}_act"


def random_hw_graph(seed: int) -> Tuple[Graph, np.ndarray, bool]:
    """The JAX package's ``random_hw_graph(seed)``: one
    ``np.random.default_rng(seed)`` drawn in the same order, weights and
    input through the port's ``fake_quant``.

    Chains 1-3 3x3 conv blocks (im2col -> MVAU, optionally maxpool),
    sometimes followed by a bare-matmul projection head and/or a
    GlobalAccPool tail.  With probability 1/4 the whole chain is instead
    generated as standalone matmul -> multithreshold pairs, which lower to
    ``matmul_int`` / ``multithreshold_int`` unfused and collapse into
    ``mvau_int`` under ``fuse_integer_datapath``.

    Returns ``(graph, x, fused)``; ``fused`` says the chain was generated
    pre-fused (mvau) rather than as standalone pairs.
    """
    rng = np.random.default_rng(seed)
    batch = int(rng.integers(1, 4))
    img = int(rng.choice([4, 5, 8]))    # 5: odd spatial extent -> odd M tiles
    c0 = int(rng.integers(1, 4))
    in_spec = _rand_act_spec(rng)
    fused = bool(rng.random() < 0.75)       # else: standalone multithreshold

    nodes, inits, dtypes = [], {}, {"x": in_spec}
    src, hw, c_in = "x", img, c0
    for b in range(int(rng.integers(1, 4))):
        wspec = _rand_weight_spec(rng)
        aspec = _rand_act_spec(rng)
        cout = int(rng.integers(1, 5))
        k = 3
        w = _fq(rng.normal(scale=1.0, size=(k * k * c_in, cout))
                .astype(np.float32), wspec)
        t = _rand_thresholds(rng, aspec, cout)
        src = _block(nodes, inits, dtypes, b, src, w, t, wspec,
                     aspec, fused, k)
        c_in = cout
        if hw % 2 == 0 and rng.random() < 0.5:
            nodes.append(Node("maxpool", [src], [f"b{b}_pool"], {"kernel": 2}))
            src, hw = f"b{b}_pool", hw // 2

    if fused and rng.random() < 0.3:
        # bare-matmul projection head: lowers to matmul_int with the
        # dequantize frontier after it (no threshold consumes its output)
        wspec = _rand_weight_spec(rng)
        inits["proj_w"] = _fq(rng.normal(size=(c_in, 4)).astype(np.float32),
                              wspec)
        dtypes["proj_w"] = wspec
        nodes.append(Node("matmul", [src, "proj_w"], ["proj"]))
        src = "proj"

    if rng.random() < 0.6:
        nodes.append(Node("global_acc_pool", [src], ["out"],
                          {"axes": [1, 2], "spatial_size": hw * hw}))
        src = "out"

    g = Graph(nodes, ["x"], [src], inits, name=f"fuzz_{seed}")
    g.dtypes.update(dtypes)
    x = rng.uniform(0.0, max(in_spec.max_value, in_spec.scale),
                    size=(batch, img, img, c0)).astype(np.float32)
    return g, _fq(x, in_spec), fused


# ---------------------------------------------------------------------------
# The wide corpus
# ---------------------------------------------------------------------------
def _float_add_bound(a: FixedPointSpec, b: FixedPointSpec,
                     spatial: int) -> int:
    """Largest pooled sum of ``a + b`` over ``spatial`` positions, in units
    of the finer grid's step: what a float GAP of a float add must keep
    below 2^24."""
    fine = max(a.frac_bits, b.frac_bits)
    return spatial * (a.qmax * 2 ** (fine - a.frac_bits)
                      + b.qmax * 2 ** (fine - b.frac_bits))


def _residual_spec(rng, prev: FixedPointSpec, spatial: int
                   ) -> FixedPointSpec:
    """The residual block's activation grid: half the time on ``prev``'s
    fraction (the ``add`` lowers to integer codes), else on another one
    (the ``add`` stays float and is fed dequantized views), drawn among
    the fractions where the GAP's float sums stay exact."""
    if rng.random() < 0.5:
        bits = int(rng.integers(max(2, prev.frac_bits), 9))
        return FixedPointSpec(bits, prev.frac_bits, signed=False)
    bits = int(rng.integers(2, 9))
    fracs = [f for f in range(bits + 1) if f != prev.frac_bits
             and _float_add_bound(FixedPointSpec(bits, f, signed=False),
                                  prev, spatial) < F32_EXACT]
    return FixedPointSpec(bits, int(rng.choice(fracs)), signed=False)


def wide_hw_graph(seed: int) -> Tuple[Graph, np.ndarray, Dict[str, Any]]:
    """A random HW-mappable graph at the card kernels' tile edges, with an
    on-grid input batch; ``np.random.default_rng((WIDE_STREAM, seed))``.

    Batch 1-5, frames of side 4, 5, 8, 11 or 17, 1-8 input channels; 1-3
    conv blocks of 1x1 or 3x3 kernels (pad ``k // 2``) with output channels
    from :data:`WIDE_CHANNELS`, weights of 2-6 bits and activations of 2-8
    bits (3-255 levels, per-tensor or per-channel tables), optionally a
    maxpool after a block.  Half the graphs end in a residual block
    (``cout == c_in``, no pool) whose output is ``add``-ed to its input and
    pooled; the others may end in the bare-matmul head and a GAP, as the
    reference's.  A quarter are standalone matmul -> multithreshold
    chains.

    Every float sum of the graph is exact in float32 (asserted per block:
    ``k·k·c_in · 2^(wbits-1) · (2^abits - 1) < 2^24``; the head and a float
    residual add are drawn only where their GAP's sums are exact), so the
    four engines agree bit for bit whatever order they sum in.

    Returns ``(graph, x, info)``; ``info`` records the draws (``fused``,
    ``residual`` None / "int" / "float", ``head``, ``gap``, per block the
    GEMM shape M x K x N and the levels L).
    """
    rng = np.random.default_rng((WIDE_STREAM, seed))
    batch = int(rng.integers(1, 6))
    img = int(rng.choice(WIDE_IMAGES))
    c0 = int(rng.integers(1, 9))
    in_spec = _rand_act_spec(rng, 8)
    fused = bool(rng.random() < 0.75)
    n_blocks = int(rng.integers(1, 4))
    residual = bool(rng.random() < 0.5)

    nodes, inits, dtypes = [], {}, {"x": in_spec}
    src, hw, c_in, spec = "x", img, c0, in_spec
    skip, skip_spec, blocks = src, spec, []
    for b in range(n_blocks):
        last = residual and b == n_blocks - 1
        wspec = _rand_weight_spec(rng)
        if last:
            skip, skip_spec = src, spec
            aspec = _residual_spec(rng, spec, hw * hw)
        else:
            aspec = _rand_act_spec(rng, 8)
        cout = c_in if last else int(rng.choice(WIDE_CHANNELS))
        k = int(rng.choice([1, 3]))
        depth = k * k * c_in
        if depth * 2 ** (wspec.total_bits - 1) * spec.qmax >= F32_EXACT:
            raise AssertionError(f"wide seed {seed} block {b}: float32 "
                                 "sums would round")
        w = _fq(rng.normal(size=(depth, cout)).astype(np.float32), wspec)
        t = _rand_thresholds(rng, aspec, cout)
        src = _block(nodes, inits, dtypes, b, src, w, t, wspec,
                     aspec, fused, k)
        blocks.append({"m": batch * hw * hw, "k": depth, "n": cout,
                       "levels": aspec.qmax, "in_bits": spec.total_bits,
                       "w_bits": wspec.total_bits, "kernel": k})
        c_in, spec = cout, aspec
        if not last and hw % 2 == 0 and rng.random() < 0.5:
            nodes.append(Node("maxpool", [src], [f"b{b}_pool"], {"kernel": 2}))
            src, hw = f"b{b}_pool", hw // 2

    head = False
    gap = residual or bool(rng.random() < 0.6)
    if residual:
        nodes.append(Node("add", [src, skip], ["res"]))
        src = "res"
        kind = "int" if skip_spec.frac_bits == spec.frac_bits else "float"
    else:
        kind = None
        # the head's pooled float sums: c_in · 2^5 · (2^abits - 1) per
        # position at the widest weights, times the positions
        exact = (not gap or c_in * 2 ** 5 * spec.qmax * hw * hw < F32_EXACT)
        if fused and rng.random() < 0.3 and exact:
            wspec = _rand_weight_spec(rng)
            inits["proj_w"] = _fq(rng.normal(size=(c_in, 4))
                                  .astype(np.float32), wspec)
            dtypes["proj_w"] = wspec
            nodes.append(Node("matmul", [src, "proj_w"], ["proj"]))
            src, head = "proj", True
    if gap:
        nodes.append(Node("global_acc_pool", [src], ["out"],
                          {"axes": [1, 2], "spatial_size": hw * hw}))
        src = "out"

    g = Graph(nodes, ["x"], [src], inits, name=f"fuzz_wide_{seed}")
    g.dtypes.update(dtypes)
    x = rng.uniform(0.0, max(in_spec.max_value, in_spec.scale),
                    size=(batch, img, img, c0)).astype(np.float32)
    info = {"seed": seed, "fused": fused, "residual": kind, "head": head,
            "gap": gap, "blocks": blocks}
    return g, _fq(x, in_spec), info


def gemm_hw_graph(seed: int) -> Tuple[Graph, np.ndarray, Dict[str, Any]]:
    """A random chain of 1-2 dense layers on an (M, K) input, the shapes a
    decode step or a small batch gives the GEMM form:
    ``np.random.default_rng((GEMM_STREAM, seed))``.

    M from :data:`GEMM_ROWS` (1 to 2,049, on both sides of the int8 GEMM
    form's route limits), K from :data:`GEMM_DEPTHS` (up to 1,440), N from
    :data:`WIDE_CHANNELS`; weights of 2-6 bits, activations of 2-8 bits
    (3-255 levels, per-tensor or per-channel tables), each layer an
    ``mvau`` or, for a quarter of the graphs, a matmul and a standalone
    multithreshold.  Every float sum is exact in float32, as in
    :func:`wide_hw_graph`.

    Returns ``(graph, x, info)``; ``info`` records ``fused`` and per layer
    M x K x N and the levels L."""
    rng = np.random.default_rng((GEMM_STREAM, seed))
    m = int(rng.choice(GEMM_ROWS))
    c0 = int(rng.choice(GEMM_DEPTHS))
    in_spec = _rand_act_spec(rng, 8)
    fused = bool(rng.random() < 0.75)

    nodes, inits, dtypes = [], {}, {"x": in_spec}
    src, c_in, spec, layers = "x", c0, in_spec, []
    for b in range(int(rng.integers(1, 3))):
        wspec = _rand_weight_spec(rng)
        aspec = _rand_act_spec(rng, 8)
        cout = int(rng.choice(WIDE_CHANNELS))
        if c_in * 2 ** (wspec.total_bits - 1) * spec.qmax >= F32_EXACT:
            raise AssertionError(f"gemm seed {seed} layer {b}: float32 "
                                 "sums would round")
        w = _fq(rng.normal(size=(c_in, cout)).astype(np.float32), wspec)
        t = _rand_thresholds(rng, aspec, cout)
        src = _block(nodes, inits, dtypes, b, src, w, t, wspec, aspec,
                     fused, None)
        layers.append({"m": m, "k": c_in, "n": cout, "levels": aspec.qmax,
                       "in_bits": spec.total_bits})
        c_in, spec = cout, aspec

    g = Graph(nodes, ["x"], [src], inits, name=f"fuzz_gemm_{seed}")
    g.dtypes.update(dtypes)
    x = rng.uniform(0.0, max(in_spec.max_value, in_spec.scale),
                    size=(m, c0)).astype(np.float32)
    return g, _fq(x, in_spec), {"seed": seed, "fused": fused,
                                "layers": layers}


# ---------------------------------------------------------------------------
# The four engines
# ---------------------------------------------------------------------------
def same_output(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Equal dtype, shape and values, all finite: bit for bit but for the
    sign of a zero, as the reference's ``assert_array_equal``."""
    return (a.dtype == b.dtype and a.shape == b.shape
            and bool(torch.isfinite(a).all()) and torch.equal(a, b))


def check_differential(graph: Graph, x: np.ndarray,
                       device: DeviceLike = None) -> Dict[str, Any]:
    """The reference's ``assert_differential`` on the port, on ``device``
    (default: the card): interpreter == f32 artifact == unfused int
    artifact == fused int artifact, bit for bit, and the structure the
    reference asserts -- the int artifacts hold integer compute nodes, a
    standalone matmul -> multithreshold pair stays a pair unfused and
    collapses under fusion, the fused artifact keeps no interior
    dequantize -> quantize pair, and the fused and unfused artifacts have
    different fingerprints.  Raises :class:`FuzzMismatch` otherwise.

    Returns ``{"interpreter", "f32", "int_unfused", "int"}`` (the four
    outputs, on the CPU), ``"dispatch"`` (``{"int_unfused", "int"}``: both
    int artifacts' dispatch tables) and ``"artifacts"`` (the three
    artifacts, keyed as their outputs).
    """
    from repro_torch.core.deploy import compile as compile_graph

    dev = resolve_device(device)
    name = graph.name
    xt = torch.from_numpy(np.ascontiguousarray(x)).to(dev)
    (ref,) = execute(graph, {graph.inputs[0]: xt}, device=dev)
    outs = {"interpreter": ref}
    arts = {}
    for key, datapath, fuse in (("f32", "f32", True),
                                ("int_unfused", "int", False),
                                ("int", "int", True)):
        dm = compile_graph(graph.copy(), recipe=FUZZ_RECIPE,
                           datapath=datapath, fuse=fuse, device=dev)
        outs[key] = dm(xt)
        arts[key] = dm
        _require(same_output(ref, outs[key]),
                 f"{name} on {dev}: interpreter != {key} artifact")
    unf, fus = arts["int_unfused"].graph, arts["int"].graph
    int_ops = {"mvau_int", "matmul_int", "multithreshold_int"}
    _require(any(n.op in int_ops for n in unf.nodes),
             f"{name}: unfused int artifact has no integer compute node")
    if any(n.op == "multithreshold" for n in graph.nodes):
        _require(any(n.op == "multithreshold_int" for n in unf.nodes),
                 f"{name}: unfused artifact lost the standalone threshold")
        _require(not any(n.op == "multithreshold_int" for n in fus.nodes),
                 f"{name}: fusion left a standalone multithreshold_int")
    _require(any(n.op == "mvau_int" for n in fus.nodes),
             f"{name}: fused int artifact contains no mvau_int node")
    _require(arts["int"].qdq_counts()["interior_pairs"] == 0,
             f"{name}: fused artifact kept an interior dequantize->quantize")
    _require(arts["int"].fingerprint() != arts["int_unfused"].fingerprint(),
             f"{name}: fused/unfused artifacts alias in the compile cache")
    result: Dict[str, Any] = {k: v.cpu() for k, v in outs.items()}
    result["dispatch"] = {"int_unfused": arts["int_unfused"].dispatch_table(),
                          "int": arts["int"].dispatch_table()}
    result["artifacts"] = arts
    return result


def lowering_summary(dm, x: np.ndarray, sms: int = H100_SMS
                     ) -> Dict[str, Any]:
    """What the card's kernels get from artifact ``dm`` on input ``x``: per
    MVAU node its route (``int8`` wgmma, ``int8_small_m`` for the int8
    GEMM form the small-M kernel takes, ``planes`` for codes of up to 24
    bits on the same tensor cores, ``core`` for wider codes on the CUDA
    cores, ``f32`` for the float MVAU), its form (``conv``: its
    ``im2col`` folded in, or ``gemm``), GEMM shape M x K x N,
    levels L and the K splits the planner gives it on ``sms``
    multiprocessors; and the counts of fused GAP tails, residual GAPs and
    ``add`` nodes that stay float.  Shapes come from running the graph on
    zeros of one image of ``x``'s shape on the CPU (M scales with the
    batch)."""
    from repro_torch.kernels import mvau as kmvau
    from repro_torch.kernels import ops as kops

    g = dm.graph.copy()
    batch, image = np.shape(x)[0], tuple(np.shape(x)[1:])
    g.infer_shapes({g.inputs[0]: np.zeros((1,) + image, np.float32)})
    conv = kops.conv_pairs(g.nodes, g.outputs)
    nodes = []
    for n in g.nodes:
        if n.op not in ("mvau", "mvau_int"):
            continue
        xs = g.shapes[n.inputs[0]]
        m, k = batch * int(np.prod(xs[:-1])), int(xs[-1])
        nn, levels = g.shapes[n.outputs[0]][-1], g.shapes[n.inputs[2]][-1]
        kind = None
        if n.op == "mvau":
            route = "f32"
        else:
            route, kind, _ = kops.int_route_of(n, g)
            if (route == "int8" and n.inputs[0] not in conv
                    and kmvau.int8_gemm_route(m, int(levels)) == "small_m"):
                route = "int8_small_m"
        if route in ("int8", "planes"):
            splits = kmvau.tc_splits(m, int(nn), k, sms,
                                     kmvau.plane_tile_rows(kind))
        elif route == "int8_small_m":
            splits = 1
        else:
            splits = kmvau.core_splits(m, int(nn), k, sms)
        nodes.append({"tensor": n.outputs[0], "route": route,
                      "form": "conv" if n.inputs[0] in conv else "gemm",
                      "m": m, "k": k, "n": int(nn), "levels": int(levels),
                      "splits": splits})
    tails = kops.gap_tails(g.nodes, g.outputs, g)
    float_adds = [n for n in g.nodes if n.op == "add" and any(
        (p := g.producer(i)) is not None and p.op == "dequantize"
        for i in n.inputs)]
    return {"mvau": nodes, "gap_tails": len(tails),
            "residual_gaps": len(kops.residual_gaps(g.nodes, g.outputs,
                                                    tails, g)),
            "float_adds": len(float_adds)}

