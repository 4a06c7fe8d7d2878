"""Per-tensor datatype inference + integer-datapath lowering.

Counterpart of the JAX package's ``core/datatypes.py``: numpy code, copied
with its arithmetic unchanged, so the lowered initializers (weight codes,
int32 threshold tables) and node attrs are byte-identical to the
reference's.  Weight codes go through the port's own ``quant.quantize``.

FINN's build flow hangs every tensor with a ``DataType`` annotation and
re-runs ``InferDataTypes`` after each transformation — bit-width is a
*propagated graph property*, not a configuration convention.  This module
ports that backbone: :func:`InferDataTypes` walks the graph in topological
order applying per-op width-propagation rules (the registry
``DATATYPE_RULES``), and :func:`LowerToIntegerDatapath` uses the resulting
annotations to rewrite the float-emulated HW graph into the integer
datapath proper — quantized inputs, integer weight codes at the narrowest
storage dtype, integer threshold tables, ``mvau_int`` nodes — bit-for-bit
equal to the f32 emulation on the fixed-point grid.

Width-propagation rules (paper / FINN accumulator arithmetic):

=================  ==========================================================
``matmul``         accumulator: ``w_bits + a_bits + ceil(log2 K)`` signed-if-
                   either, ``frac = a_frac + w_frac`` (:func:`accumulator_spec`)
``multithreshold`` output: ``ceil(log2(L+1))`` unsigned (L thresholds), frac
``mvau``           from ``out_scale = 2^-frac`` (:func:`threshold_output_spec`)
``global_acc_pool``sum: ``in_bits + ceil(log2(H*W))``, same frac/signedness
``add``            ``max(bits) + 1`` at a common frac
``mul``            power-of-two scalar shifts ``frac``; anything else leaves
                   the fixed-point grid → annotation becomes None (float)
``transpose`` &c.  data movement preserves the spec
=================  ==========================================================

Both passes are registered with the PassManager (``infer_datatypes``,
``lower_to_integer_datapath``); the lowering *requires* the
``datatypes_annotated`` structural property, so a recipe that skips
inference fails with :class:`~repro_torch.core.passes.PassOrderError` instead of
silently mis-lowering — the same ordering discipline the streamline passes
get.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional

import numpy as np

import torch

from repro_torch.core import quant
from repro_torch.core.graph import Graph, GraphBuildError, Node
from repro_torch.core.quant import FixedPointSpec

__all__ = [
    "DATATYPE_RULES",
    "accumulator_spec",
    "threshold_output_spec",
    "datatype_rule",
    "register_datatype_rule",
    "InferDataTypes",
    "LowerToIntegerDatapath",
    "FuseIntegerDatapath",
    "F32_EXACT_BOUND",
]

# Largest integer magnitude for which EVERY partial sum of an integer-code
# matmul is exactly representable in float32 (24-bit mantissa).  When the
# reachable accumulator range stays inside ±2**24, running the code matmul
# through the f32 GEMM (the only fast GEMM most non-TPU backends have) is
# bit-for-bit equal to exact integer accumulation — the kernels key their
# fast path off the ``acc_f32_exact`` attr derived from this bound.
F32_EXACT_BOUND = 2 ** 24


# ---------------------------------------------------------------------------
# Spec arithmetic
# ---------------------------------------------------------------------------
def accumulator_spec(x_spec: FixedPointSpec, w_spec: FixedPointSpec,
                     k: int) -> FixedPointSpec:
    """MatMul/MVAU accumulator format: ``w_bits + a_bits + ceil(log2 K)``.

    This is FINN's conservative accumulator sizing: the widest partial sum of
    K products of a ``w_bits`` × ``a_bits`` code pair.  The fractional point
    of a product is the sum of the operand fractions.  (Module-level
    function on purpose: the lowering resolves it through the module at call
    time, so tests can inject a wrong-width rule and watch golden-IO
    verification catch it.)
    """
    growth = max(int(math.ceil(math.log2(max(k, 1)))), 0)
    return FixedPointSpec(
        total_bits=x_spec.total_bits + w_spec.total_bits + growth,
        frac_bits=x_spec.frac_bits + w_spec.frac_bits,
        signed=x_spec.signed or w_spec.signed)


def threshold_output_spec(n_levels: int, out_base: int = 0,
                          out_scale: float = 1.0,
                          out_bias: float = 0.0) -> Optional[FixedPointSpec]:
    """MultiThreshold/MVAU output format: codes in ``[base, base + L]``.

    For the common FINN case (base 0) that is ``ceil(log2(L+1))`` unsigned.
    ``out_scale`` must be an exact power of two (it *is* the code scale);
    otherwise the output is off-grid and the spec is None.
    """
    if out_bias != 0.0 or out_scale <= 0.0:
        return None
    frac = -math.log2(out_scale)
    if abs(frac - round(frac)) > 1e-9:
        return None
    frac = int(round(frac))
    lo, hi = int(out_base), int(out_base) + int(n_levels)
    if lo >= 0:
        bits = max(int(math.ceil(math.log2(hi + 1))) if hi > 0 else 1, 1)
        return FixedPointSpec(bits, frac, signed=False)
    bits = 1 + max(int(math.ceil(math.log2(max(-lo, hi + 1)))), 1)
    return FixedPointSpec(bits, frac, signed=True)


def _spec_for_levels(g: Graph, tensor: str) -> Optional[int]:
    """Number of threshold levels L for a threshold tensor, if resolvable."""
    if tensor in g.initializers:
        return int(np.asarray(g.initializers[tensor]).shape[-1])
    if tensor in g.shapes:
        return int(g.shapes[tensor][-1])
    return None


def _inner_dim(g: Graph, w_tensor: str) -> Optional[int]:
    if w_tensor in g.initializers:
        return int(np.asarray(g.initializers[w_tensor]).shape[0])
    if w_tensor in g.shapes:
        return int(g.shapes[w_tensor][0])
    return None


# ---------------------------------------------------------------------------
# Per-op rules: fn(node, in_specs, graph) -> spec-or-None for all outputs
# ---------------------------------------------------------------------------
Rule = Callable[[Node, List[Optional[FixedPointSpec]], Graph],
                Optional[FixedPointSpec]]

DATATYPE_RULES: Dict[str, Rule] = {}


def register_datatype_rule(*ops: str, override: bool = False):
    """Public registration decorator for per-op datatype rules.

    A rule is ``fn(node, in_specs, graph) -> Optional[FixedPointSpec]`` —
    the spec assigned to every output of ``node`` (``None`` keeps the
    outputs floating point).  New workloads extend the IR by registering
    rules for their ops next to their export code; nothing under
    ``repro_torch/core`` needs to know the op exists.

    Re-registering an op raises — a silent overwrite would let two model
    modules fight over an op's semantics with import order deciding the
    winner.  Pass ``override=True`` to replace a rule on purpose.
    """
    if not ops or any(not isinstance(op, str) for op in ops):
        raise TypeError("register_datatype_rule takes one or more op names")

    def deco(fn: Rule) -> Rule:
        for op in ops:
            prev = DATATYPE_RULES.get(op)
            if prev is not None and prev is not fn and not override:
                raise ValueError(
                    f"datatype rule for op '{op}' is already registered "
                    f"({getattr(prev, '__name__', prev)!r}); pass "
                    "override=True to replace it")
            DATATYPE_RULES[op] = fn
        return fn
    return deco


def datatype_rule(*ops: str):
    """The reference's deprecated alias of :func:`register_datatype_rule`
    (same conflict semantics: re-registering an op raises)."""
    return register_datatype_rule(*ops)


@register_datatype_rule("im2col", "transpose", "maxpool", "flatten", "relu")
def _rule_passthrough(node, in_specs, g):
    """Data movement / monotone selection: same grid in, same grid out."""
    return in_specs[0]


@register_datatype_rule("matmul")
def _rule_matmul(node, in_specs, g):
    if len(node.inputs) != 2 or in_specs[0] is None or in_specs[1] is None:
        return None                      # float operand or biased matmul
    k = _inner_dim(g, node.inputs[1])
    if k is None:
        return None
    return accumulator_spec(in_specs[0], in_specs[1], k)


@register_datatype_rule("multithreshold", "mvau")
def _rule_threshold(node, in_specs, g):
    t_name = node.inputs[-1]
    levels = _spec_for_levels(g, t_name)
    if levels is None:
        return None
    return threshold_output_spec(
        levels, node.attrs.get("out_base", 0),
        node.attrs.get("out_scale", 1.0), node.attrs.get("out_bias", 0.0))


@register_datatype_rule("mvau_int", "matmul_int", "multithreshold_int")
def _rule_mvau_int(node, in_specs, g):
    bits = node.attrs.get("out_bits")
    if bits is None:
        return None
    return FixedPointSpec(bits, node.attrs["out_frac_bits"],
                          node.attrs.get("out_signed", False))


@register_datatype_rule("requantize")
def _rule_requantize(node, in_specs, g):
    return FixedPointSpec(node.attrs["bits"], node.attrs["frac_bits"],
                          node.attrs.get("signed", True))


@register_datatype_rule("global_acc_pool")
def _rule_gap(node, in_specs, g):
    spec = in_specs[0]
    if spec is None:
        return None
    spatial = node.attrs.get("spatial_size")
    if spatial is None and node.inputs[0] in g.shapes:
        shape = g.shapes[node.inputs[0]]
        spatial = int(np.prod([shape[a] for a in node.attrs["axes"]]))
    if spatial is None:
        return None
    growth = max(int(math.ceil(math.log2(max(spatial, 1)))), 0)
    return FixedPointSpec(spec.total_bits + growth, spec.frac_bits,
                          spec.signed)


@register_datatype_rule("add")
def _rule_add(node, in_specs, g):
    if len(node.inputs) != 2:
        return None                      # scalar-attr add: stays float
    a, b = in_specs
    if a is None or b is None or a.frac_bits != b.frac_bits:
        return None                      # mismatched grids: not code-exact
    return FixedPointSpec(max(a.total_bits, b.total_bits) + 1, a.frac_bits,
                          a.signed or b.signed)


@register_datatype_rule("mul")
def _rule_mul(node, in_specs, g):
    if len(node.inputs) != 1 or in_specs[0] is None:
        return None
    c = float(node.attrs.get("value", float("nan")))
    if not (c > 0.0) or not math.isfinite(c):
        return None
    mantissa, exp = math.frexp(c)        # c = mantissa * 2**exp
    if mantissa != 0.5:
        return None                      # not a power of two: off-grid
    shift = exp - 1
    spec = in_specs[0]
    return FixedPointSpec(spec.total_bits, spec.frac_bits - shift, spec.signed)


@register_datatype_rule("quantize")
def _rule_quantize(node, in_specs, g):
    return FixedPointSpec(node.attrs["bits"], node.attrs["frac_bits"],
                          node.attrs.get("signed", True))


@register_datatype_rule("dequantize", "reduce_mean")
def _rule_float(node, in_specs, g):
    return None


@register_datatype_rule("embed")
def _rule_embed(node, in_specs, g):
    """Token gather: rows of the table, so the table's grid passes through."""
    return in_specs[0]


@register_datatype_rule("rmsnorm", "silu", "gelu", "attn_decode",
                        "attn_prefill")
def _rule_float_transformer(node, in_specs, g):
    """Normalization, smooth activations and softmax attention are real
    valued: the decode workload keeps them floating point and re-enters the
    integer domain at the next activation quantizer (which the lowering
    streamlines to a single ``quantize``)."""
    return None


# ---------------------------------------------------------------------------
# InferDataTypes — the annotation pass
# ---------------------------------------------------------------------------
def InferDataTypes(g: Graph) -> Graph:
    """Propagate per-tensor FixedPointSpec annotations through the graph.

    Seeds come from ``g.dtypes`` (exporters annotate graph inputs and weight
    initializers); every node-output tensor gets an entry — a spec when the
    op's rule can derive one, None (float) otherwise.  Pure annotation: the
    executed function is untouched, so this pass is trivially golden-IO
    clean.
    """
    g = g.copy()
    g.toposort()
    dt: Dict[str, Optional[FixedPointSpec]] = dict(g.dtypes)
    for node in g.nodes:
        rule = DATATYPE_RULES.get(node.op)
        in_specs = [dt.get(t) for t in node.inputs]
        spec = rule(node, in_specs, g) if rule is not None else None
        for out in node.outputs:
            dt[out] = spec
    g.dtypes = dt
    return g


# ---------------------------------------------------------------------------
# LowerToIntegerDatapath — the int rewrite
# ---------------------------------------------------------------------------
_INT_EXACT_PASSTHROUGH = {"im2col", "maxpool", "transpose", "flatten"}


def _storage_array(codes: np.ndarray, spec: FixedPointSpec):
    """Integer codes → narrowest dense storage (packed int8 for <=4 bits).

    Returns ``(array, packed)``.
    """
    if spec.total_bits <= 4 and codes.shape[-1] % 2 == 0:
        return quant.pack_int4(torch.from_numpy(codes)).numpy(), True
    return codes.astype(_NP_STORAGE[quant.storage_dtype(spec)]), False


_NP_STORAGE = {torch.int8: np.int8, torch.int16: np.int16,
               torch.int32: np.int32}


def _quantize_np(w: np.ndarray, spec: FixedPointSpec) -> np.ndarray:
    """``quant.quantize`` on a numpy initializer -> int32 numpy codes."""
    return quant.quantize(torch.from_numpy(np.ascontiguousarray(w)),
                          spec).numpy()


def _fits_int8(spec: FixedPointSpec) -> bool:
    return spec.qmin >= -128 and spec.qmax <= 127


_INT32_MIN = -(2 ** 31)
_INT32_MAX = 2 ** 31 - 1


def _pow2_frac(scale: float) -> Optional[int]:
    """``f`` such that ``2**-f == scale`` exactly, else None."""
    if not (scale > 0.0) or not math.isfinite(scale):
        return None
    mantissa, exp = math.frexp(scale)     # scale = mantissa * 2**exp
    if mantissa != 0.5:
        return None
    return 1 - exp


def _subset_sum_bounds(w_codes: np.ndarray, x_lo: int,
                       x_hi: int) -> tuple:
    """Bounds on EVERY partial sum of ``x @ w`` over integer codes.

    Each product ``w[k, n] * x[k]`` lies in ``[min(w*x_lo, w*x_hi),
    max(w*x_lo, w*x_hi)]``; any subset of them (any accumulation order's
    intermediate state) sums to at most the positive parts and at least the
    negative parts.  This is the bound that gates both the int32-overflow
    check and the f32-exact-GEMM window (``F32_EXACT_BOUND``): the *final*
    range [acc_lo, acc_hi] is not enough, because signed cancellation can
    make an intermediate sum exceed the final extremes.
    """
    w64 = w_codes.astype(np.int64)
    term_hi = np.maximum(w64 * x_lo, w64 * x_hi)
    term_lo = np.minimum(w64 * x_lo, w64 * x_hi)
    sub_hi = int(np.clip(term_hi, 0, None).sum(axis=0).max())
    sub_lo = int(np.clip(term_lo, None, 0).sum(axis=0).min())
    return sub_lo, sub_hi


def LowerToIntegerDatapath(g: Graph) -> Graph:
    """Rewrite the float-emulated HW graph to the integer datapath.

    * graph inputs with a spec annotation gain a ``quantize`` node (the
      deployed artifact keeps the same on-grid float input contract);
    * every ``mvau`` whose activation operand is integer-domain becomes
      ``mvau_int``: the weight initializer is replaced by integer codes at
      the narrowest storage dtype (packed int4 below 5 bits), and the float
      threshold table is lowered to integer accumulator-domain thresholds
      ``ceil(T / (s_x * s_w))`` clamped to the annotated accumulator range —
      exact because an integer accumulator satisfies ``a >= t`` iff
      ``a >= ceil(t)``;
    * code-exact ops (im2col / maxpool / transpose / flatten / add on a
      common grid / GlobalAccPool) stay in the integer domain;
    * at the first op that is not code-exact (e.g. the GAP 1/(H·W) scalar
      Mul) and at graph outputs, a ``dequantize`` node restores the float
      value, so the lowered graph is bit-for-bit equal to its input graph.
    """
    g = g.copy()
    g.toposort()
    if not any(s is not None for s in g.dtypes.values()):
        raise GraphBuildError(
            f"graph '{g.name}' has no datatype annotations to lower from; "
            "seed g.dtypes (exporters do) and run 'infer_datatypes' first")

    int_dom: Dict[str, FixedPointSpec] = {}

    # 1. quantize annotated graph inputs
    for inp in g.inputs:
        spec = g.dtypes.get(inp)
        if spec is None:
            continue
        codes = g.fresh_name(inp + "_codes")
        for c in list(g.consumers(inp)):
            for pos, t in enumerate(c.inputs):
                if t == inp:
                    g.set_input(c, pos, codes)
        g.insert_node(0, Node("quantize", [inp], [codes],
                              {"bits": spec.total_bits,
                               "frac_bits": spec.frac_bits,
                               "signed": spec.signed}))
        g.dtypes[codes] = spec
        int_dom[codes] = spec
    g.toposort()

    deq_alias: Dict[str, str] = {}

    def dequantized(tensor: str, before: Node) -> str:
        """Get-or-create the float view of an int-domain tensor."""
        if tensor in deq_alias:
            return deq_alias[tensor]
        spec = int_dom[tensor]
        name = g.fresh_name(tensor + "_deq")
        g.insert_node(g.nodes.index(before),
                      Node("dequantize", [tensor], [name],
                           {"scale": spec.scale}))
        g.dtypes[name] = None
        deq_alias[tensor] = name
        return name

    # 2. walk in topological order, extending the integer domain
    for node in list(g.nodes):
        if node.op == "quantize":
            # Exporter-placed (or rewritten, below) quantize: its output IS
            # integer codes on the attr grid — register it so downstream
            # matmuls see an integer-domain operand.
            spec = FixedPointSpec(node.attrs["bits"],
                                  node.attrs["frac_bits"],
                                  node.attrs.get("signed", True))
            int_dom.setdefault(node.outputs[0], spec)
            g.dtypes[node.outputs[0]] = int_dom[node.outputs[0]]
            continue
        if node.op == "embed":
            t_name, ids_name = node.inputs
            wspec = g.dtypes.get(t_name)
            if wspec is not None and t_name in g.initializers:
                w = np.asarray(g.initializers[t_name])
                codes = _quantize_np(w, wspec)
                stored, packed = _storage_array(codes, wspec)
                g.initializers[t_name] = stored
                g.dtypes[t_name] = wspec
                node.attrs = dict(node.attrs, w_packed=packed,
                                  w_bits=wspec.total_bits)
                int_dom[node.outputs[0]] = wspec
                g.dtypes[node.outputs[0]] = wspec
                continue
            # unannotated table: a float gather; the generic frontier below
            # has nothing to rewrite (ids are not grid tensors)
            continue
        if node.op == "mvau":
            x_name, w_name, t_name = node.inputs
            xspec = int_dom.get(x_name)
            wspec = g.dtypes.get(w_name)
            out_scale = float(node.attrs.get("out_scale", 1.0))
            out_base = int(node.attrs.get("out_base", 0))
            levels = _spec_for_levels(g, t_name)
            out_spec = threshold_output_spec(
                levels or 0, out_base, out_scale,
                float(node.attrs.get("out_bias", 0.0)))
            if xspec is None or wspec is None or w_name not in g.initializers \
                    or t_name not in g.initializers or out_spec is None:
                raise GraphBuildError(
                    f"cannot lower mvau '{node.outputs[0]}' in graph "
                    f"'{g.name}' to the integer datapath: needs an integer-"
                    "domain activation, an annotated weight initializer and "
                    "a power-of-two out_scale")
            w = np.asarray(g.initializers[w_name])
            k = w.shape[0]
            acc = accumulator_spec(xspec, wspec, k)
            w_codes = _quantize_np(w, wspec)
            stored, packed = _storage_array(w_codes, wspec)
            # Exact reachable accumulator range from the REAL weight codes
            # (FINN's accumulator minimization): every partial sum is a
            # subset sum of per-term extremes, so [lo, hi] bounds all
            # intermediate states too.  The runtime datapath accumulates in
            # int32 — a graph whose true range exceeds that must fail here,
            # not wrap silently.
            w64 = w_codes.astype(np.int64)
            pos = np.clip(w64, 0, None).sum(axis=0)
            neg = np.clip(w64, None, 0).sum(axis=0)
            acc_hi = int((pos * xspec.qmax + neg * xspec.qmin).max())
            acc_lo = int((pos * xspec.qmin + neg * xspec.qmax).min())
            sub_lo, sub_hi = _subset_sum_bounds(w_codes, xspec.qmin,
                                                xspec.qmax)
            # >= so that the never-fires sentinel acc_hi + 1 stays int32 too
            if sub_lo < _INT32_MIN or sub_hi >= _INT32_MAX:
                raise GraphBuildError(
                    f"mvau '{node.outputs[0]}' in graph '{g.name}': reachable "
                    f"accumulator range [{sub_lo}, {sub_hi}] exceeds the "
                    "int32 datapath — narrow the weight/activation grid "
                    f"(annotated accumulator: {acc.describe()})")
            t = np.asarray(g.initializers[t_name], np.float64)
            t_int = np.ceil(t / (float(xspec.scale) * float(wspec.scale)))
            # clamp to the accumulator's representable range (+1: a threshold
            # above every reachable sum must never fire) — this is where a
            # wrong accumulator-width rule becomes a semantic error that
            # golden-IO verification catches
            t_int = np.clip(t_int, float(acc.qmin), float(acc.qmax) + 1.0)
            t_int = np.clip(t_int, float(acc_lo), float(acc_hi) + 1.0)
            # count = Σ 1[acc ≥ Tᵢ] is invariant under threshold permutation,
            # so the sorted table is a free canonical form — it is what lets
            # the fused kernels binary-search instead of dense-compare
            t_int = np.sort(t_int.astype(np.int32), axis=-1)
            g.initializers[w_name] = stored
            g.initializers[t_name] = t_int
            g.dtypes[w_name] = wspec
            g.dtypes[t_name] = acc
            node.op = "mvau_int"
            node.attrs = {
                "out_base": out_base,
                "w_packed": packed,
                "w_bits": wspec.total_bits,
                "int8_ok": _fits_int8(xspec) and _fits_int8(wspec),
                "out_bits": out_spec.total_bits,
                "out_frac_bits": out_spec.frac_bits,
                "out_signed": out_spec.signed,
                "acc_lo": acc_lo,
                "acc_hi": acc_hi,
                "acc_f32_exact": (sub_lo >= -F32_EXACT_BOUND
                                  and sub_hi <= F32_EXACT_BOUND),
                "t_sorted": True,
            }
            int_dom[node.outputs[0]] = out_spec
            g.dtypes[node.outputs[0]] = out_spec
            continue
        if node.op == "multithreshold":
            x_name, t_name = node.inputs
            xspec = int_dom.get(x_name)
            out_scale = float(node.attrs.get("out_scale", 1.0))
            out_base = int(node.attrs.get("out_base", 0))
            levels = _spec_for_levels(g, t_name)
            out_spec = threshold_output_spec(
                levels or 0, out_base, out_scale,
                float(node.attrs.get("out_bias", 0.0)))
            if xspec is None and out_spec is not None \
                    and t_name in g.initializers \
                    and node.attrs.get("channel_axis", -1) == -1:
                t = np.asarray(g.initializers[t_name], np.float32)
                if t.ndim == 1 and np.array_equal(
                        t, np.asarray(quant.thresholds_for(out_spec),
                                      np.float32)):
                    # Float-fed activation quantizer whose table IS the
                    # canonical grid for out_spec: by thresholds_for's
                    # round-half-even contract the level count equals the
                    # quantize() code, so the 2^b−1-way counting compare
                    # streamlines to one round+clip and the output enters
                    # the integer domain.  (The attention and norm ops
                    # between quantizers stay float: this is where the
                    # decode workload re-enters the integer datapath.)
                    node.op = "quantize"
                    node.inputs = [x_name]
                    node.attrs = {"bits": out_spec.total_bits,
                                  "frac_bits": out_spec.frac_bits,
                                  "signed": out_spec.signed}
                    g.invalidate()
                    _retire_initializer(g, t_name)
                    int_dom[node.outputs[0]] = out_spec
                    g.dtypes[node.outputs[0]] = out_spec
                    continue
            if xspec is None or t_name not in g.initializers \
                    or out_spec is None \
                    or node.attrs.get("channel_axis", -1) != -1 \
                    or xspec.qmax > F32_EXACT_BOUND \
                    or xspec.qmin < -F32_EXACT_BOUND:
                raise GraphBuildError(
                    f"cannot lower multithreshold '{node.outputs[0]}' in "
                    f"graph '{g.name}' to the integer datapath: needs an "
                    "integer-domain activation inside the f32-exact window, "
                    "trailing-axis constant thresholds and a power-of-two "
                    "out_scale")
            # Exact input-code range: the producer's reachable accumulator
            # range when known (matmul_int), else the annotated spec range.
            x_lo, x_hi = xspec.qmin, xspec.qmax
            prod = g.producer(x_name)
            if prod is not None and prod.op == "matmul_int":
                x_lo, x_hi = prod.attrs["acc_lo"], prod.attrs["acc_hi"]
            if x_lo < _INT32_MIN or x_hi >= _INT32_MAX:
                raise GraphBuildError(
                    f"multithreshold '{node.outputs[0]}' in graph '{g.name}': "
                    f"input code range [{x_lo}, {x_hi}] exceeds the int32 "
                    "datapath")
            t = np.asarray(g.initializers[t_name], np.float64)
            # q ≥ ceil(T / s) ⟺ q·s ≥ T (s > 0): exact threshold rescale
            t_int = np.ceil(t / float(xspec.scale))
            t_int = np.clip(t_int, float(x_lo), float(x_hi) + 1.0)
            t_int = np.sort(t_int.astype(np.int32), axis=-1)
            g.initializers[t_name] = t_int
            g.dtypes[t_name] = xspec
            node.op = "multithreshold_int"
            node.attrs = {
                "out_base": out_base,
                "out_bits": out_spec.total_bits,
                "out_frac_bits": out_spec.frac_bits,
                "out_signed": out_spec.signed,
                "t_sorted": True,
            }
            int_dom[node.outputs[0]] = out_spec
            g.dtypes[node.outputs[0]] = out_spec
            continue
        if node.op == "matmul" and len(node.inputs) == 2:
            x_name, w_name = node.inputs
            xspec = int_dom.get(x_name)
            wspec = g.dtypes.get(w_name)
            if xspec is not None and wspec is not None \
                    and w_name in g.initializers:
                w = np.asarray(g.initializers[w_name])
                acc = accumulator_spec(xspec, wspec, w.shape[0])
                w_codes = _quantize_np(w, wspec)
                sub_lo, sub_hi = _subset_sum_bounds(w_codes, xspec.qmin,
                                                    xspec.qmax)
                # Only rewrite inside the f32-exact window: there the float
                # emulation's GEMM over dequantized values IS the integer
                # matmul (scaled by an exact power of two), so the rewrite
                # is bit-for-bit.  Outside it the float graph's own sums
                # round, and an integer rewrite would *change* semantics.
                if -F32_EXACT_BOUND <= sub_lo and sub_hi <= F32_EXACT_BOUND:
                    w64 = w_codes.astype(np.int64)
                    pos = np.clip(w64, 0, None).sum(axis=0)
                    neg = np.clip(w64, None, 0).sum(axis=0)
                    acc_hi = int((pos * xspec.qmax + neg * xspec.qmin).max())
                    acc_lo = int((pos * xspec.qmin + neg * xspec.qmax).min())
                    stored, packed = _storage_array(w_codes, wspec)
                    g.initializers[w_name] = stored
                    g.dtypes[w_name] = wspec
                    node.op = "matmul_int"
                    node.attrs = {
                        "w_packed": packed,
                        "w_bits": wspec.total_bits,
                        "int8_ok": _fits_int8(xspec) and _fits_int8(wspec),
                        "out_bits": acc.total_bits,
                        "out_frac_bits": acc.frac_bits,
                        "out_signed": acc.signed,
                        "acc_lo": acc_lo,
                        "acc_hi": acc_hi,
                        "acc_f32_exact": True,
                    }
                    int_dom[node.outputs[0]] = acc
                    g.dtypes[node.outputs[0]] = acc
                    continue
        in_int = [t for t in node.inputs if t in int_dom]
        lowerable = False
        out_spec = None
        if in_int and len(in_int) == len(
                [t for t in node.inputs if t not in g.initializers]):
            if node.op in _INT_EXACT_PASSTHROUGH:
                lowerable, out_spec = True, int_dom[node.inputs[0]]
            elif node.op == "add" and len(node.inputs) == 2:
                a, b = (int_dom.get(t) for t in node.inputs)
                if a is not None and b is not None \
                        and a.frac_bits == b.frac_bits:
                    lowerable = True
                    out_spec = _rule_add(node, [a, b], g)
            elif node.op == "global_acc_pool":
                lowerable = True
                out_spec = _rule_gap(node, [int_dom[node.inputs[0]]], g) \
                    or int_dom[node.inputs[0]]
        if lowerable:
            for out in node.outputs:
                int_dom[out] = out_spec
                g.dtypes[out] = out_spec
            continue
        # frontier: this node stays float — feed it dequantized views
        for t in in_int:
            alias = dequantized(t, node)
            for pos, name in enumerate(node.inputs):
                if name == t:
                    g.set_input(node, pos, alias)

    # 3. graph outputs that ended up integer-domain get dequantized in place
    for out in list(g.outputs):
        if out not in int_dom:
            continue
        spec = int_dom[out]
        prod = g.producer(out)
        raw = g.fresh_name(out + "_int")
        g.set_output(prod, prod.outputs.index(out), raw)
        # anything else reading the codes keeps reading them under the new
        # name; only the graph-output view is dequantized
        for c in list(g.consumers(out)):
            for pos, name in enumerate(c.inputs):
                if name == out:
                    g.set_input(c, pos, raw)
        g.insert_after(prod, Node("dequantize", [raw], [out],
                                  {"scale": spec.scale}))
        int_dom[raw] = spec
        g.dtypes[raw] = spec
        g.dtypes[out] = None
    g.toposort()
    return g


# ---------------------------------------------------------------------------
# FuseIntegerDatapath — collapse the lowered graph into fused integer nodes
# ---------------------------------------------------------------------------
_THRESHOLDED_OPS = ("mvau_int", "multithreshold_int")


def _compose_thresholds(t1: np.ndarray, base1: int,
                        t2: np.ndarray) -> np.ndarray:
    """Fold a threshold stage into its producer's threshold table.

    Stage 1 emits ``out1 = base1 + Σᵢ 1[x ≥ t1ᵢ]``; stage 2 computes
    ``Σⱼ 1[out1 ≥ t2ⱼ]``.  With t1 sorted ascending, ``out1 ≥ t2ⱼ`` ⟺
    ``count1 ≥ cⱼ`` (``cⱼ = t2ⱼ − base1``) ⟺ ``x ≥ t1[cⱼ − 1]`` — so the
    chain is ONE threshold stage over x with table ``t1[t2 − base1 − 1]``.
    ``cⱼ ≤ 0`` always fires (sentinel INT32_MIN: every int32 x passes);
    ``cⱼ > L1`` never fires (sentinel INT32_MAX: lowering guarantees
    reachable codes stay strictly below it).  The composed table is sorted
    before return — counts are permutation-invariant, so that is free.
    """
    t1 = np.sort(np.asarray(t1, np.int64), axis=-1)
    t2 = np.asarray(t2, np.int64)
    per_channel = t1.ndim == 2 or t2.ndim == 2
    l1 = t1.shape[-1]
    t1 = np.atleast_2d(t1)                        # (C1|1, L1)
    c = np.atleast_2d(t2) - int(base1)            # (C2|1, L2)
    channels = max(t1.shape[0], c.shape[0])
    t1 = np.broadcast_to(t1, (channels, l1))
    c = np.broadcast_to(c, (channels, c.shape[-1]))
    idx = np.clip(c - 1, 0, l1 - 1)
    comp = np.take_along_axis(t1, idx, axis=-1)
    comp = np.where(c <= 0, np.int64(_INT32_MIN), comp)
    comp = np.where(c > l1, np.int64(_INT32_MAX), comp)
    comp = np.sort(comp, axis=-1).astype(np.int32)
    return comp if per_channel else comp[0]


def _requantize_plan(g: Graph, quant_node: Node) -> Optional[Dict[str, int]]:
    """Attrs for folding a dequantize→quantize pair into ``requantize``,
    or None when the pair must stay (off-grid scale, unannotated source, or
    a source range where the float round-trip itself is inexact).  Shared
    by the fusion pass and the ``integer_fused`` property check so the two
    can never disagree about what is fusable."""
    deq = g.producer(quant_node.inputs[0])
    if deq is None or deq.op != "dequantize":
        return None
    f1 = _pow2_frac(float(deq.attrs["scale"]))
    if f1 is None:
        return None
    src_spec = g.dtypes.get(deq.inputs[0])
    if src_spec is None or src_spec.qmax > F32_EXACT_BOUND \
            or src_spec.qmin < -F32_EXACT_BOUND:
        return None                      # float view may round: keep the pair
    bits = int(quant_node.attrs["bits"])
    frac = int(quant_node.attrs["frac_bits"])
    signed = bool(quant_node.attrs.get("signed", True))
    shift = frac - f1
    out_spec = FixedPointSpec(bits, frac, signed)
    if shift > 0 and ((out_spec.qmax + 1) << shift >= _INT32_MAX
                      or (-out_spec.qmin + 1) << shift >= _INT32_MAX):
        return None                      # upshift could overflow int32
    return {"shift": shift, "bits": bits, "frac_bits": frac,
            "signed": signed}


def _fusion_candidates(g: Graph) -> List[tuple]:
    """Remaining fusion opportunities — () iff the graph is integer-fused."""
    out = []
    for node in g.nodes:
        if node.op == "multithreshold_int":
            prod = g.producer(node.inputs[0])
            if prod is not None and prod.op in ("matmul_int",) + \
                    _THRESHOLDED_OPS \
                    and node.inputs[0] not in g.outputs \
                    and len(g.consumers(node.inputs[0])) == 1 \
                    and prod.inputs[-1] in g.initializers \
                    and node.inputs[1] in g.initializers:
                kind = "fuse_matmul" if prod.op == "matmul_int" \
                    else "fuse_chain"
                out.append((kind, node, prod))
                continue
        if node.op == "quantize" and _requantize_plan(g, node) is not None:
            out.append(("requantize", node, g.producer(node.inputs[0])))
        elif node.op in _THRESHOLDED_OPS \
                and not node.attrs.get("t_sorted", False) \
                and node.inputs[-1] in g.initializers:
            out.append(("sort", node, None))
    return out


def _retire_initializer(g: Graph, name: str) -> None:
    if name in g.initializers and not g.consumers(name):
        del g.initializers[name]
        g.dtypes.pop(name, None)


def FuseIntegerDatapath(g: Graph) -> Graph:
    """Collapse the lowered integer graph into fused end-to-end integer nodes.

    Three rewrites, applied to fixpoint (each is exact, argued per helper):

    * ``matmul_int → multithreshold_int`` becomes one ``mvau_int`` — the
      thresholding happens in-register on the accumulator, never
      materializing the wide intermediate;
    * ``mvau_int|multithreshold_int → multithreshold_int`` chains collapse
      by composing the two integer tables (:func:`_compose_thresholds`);
    * interior ``dequantize → quantize`` pairs become a single integer
      ``requantize`` (pure shift + round-half-even + clip) — activations
      stay integer codes across what used to be a float round-trip.

    Unsorted threshold tables are sorted in place (counts are
    permutation-invariant), so every surviving table is binary-searchable.
    """
    g = g.copy()
    g.toposort()
    while True:
        cands = _fusion_candidates(g)
        if not cands:
            break
        kind, node, prod = cands[0]
        if kind == "sort":
            t_name = node.inputs[-1]
            g.initializers[t_name] = np.sort(
                np.asarray(g.initializers[t_name]), axis=-1)
            node.attrs["t_sorted"] = True
        elif kind == "requantize":
            plan = _requantize_plan(g, node)
            deq = prod
            node.op = "requantize"
            node.attrs = plan
            g.set_input(node, 0, deq.inputs[0])
            if not g.consumers(deq.outputs[0]) \
                    and deq.outputs[0] not in g.outputs:
                g.remove_node(deq)
        elif kind == "fuse_matmul":
            mid = node.inputs[0]
            t_name = node.inputs[1]
            out_dt = {o: g.dtypes.get(o) for o in node.outputs}
            fused = Node("mvau_int",
                         [prod.inputs[0], prod.inputs[1], t_name],
                         list(node.outputs),
                         {"out_base": node.attrs["out_base"],
                          "out_bits": node.attrs["out_bits"],
                          "out_frac_bits": node.attrs["out_frac_bits"],
                          "out_signed": node.attrs["out_signed"],
                          "t_sorted": node.attrs.get("t_sorted", False),
                          "w_packed": prod.attrs["w_packed"],
                          "w_bits": prod.attrs["w_bits"],
                          "int8_ok": prod.attrs["int8_ok"],
                          "acc_lo": prod.attrs["acc_lo"],
                          "acc_hi": prod.attrs["acc_hi"],
                          "acc_f32_exact": prod.attrs["acc_f32_exact"]})
            pos = g.nodes.index(prod)
            g.remove_node(node)
            g.remove_node(prod)
            g.insert_node(pos, fused)
            g.dtypes.pop(mid, None)
            g.dtypes.update(out_dt)
        else:                                       # fuse_chain
            inner = prod
            t1_name = inner.inputs[-1]
            t2_name = node.inputs[1]
            mid = node.inputs[0]
            composed = _compose_thresholds(
                g.initializers[t1_name], inner.attrs["out_base"],
                g.initializers[t2_name])
            new_t = g.fresh_name(t1_name + "_fused")
            g.initializers[new_t] = composed
            g.dtypes[new_t] = g.dtypes.get(t1_name)
            out_dt = {o: g.dtypes.get(o) for o in node.outputs}
            g.set_input(inner, len(inner.inputs) - 1, new_t)
            for key in ("out_base", "out_bits", "out_frac_bits",
                        "out_signed"):
                inner.attrs[key] = node.attrs[key]
            inner.attrs["t_sorted"] = True
            g.remove_node(node)
            g.set_output(inner, 0, node.outputs[0])
            g.dtypes.pop(mid, None)
            g.dtypes.update(out_dt)
            _retire_initializer(g, t1_name)
            _retire_initializer(g, t2_name)
    g.toposort()
    return g
