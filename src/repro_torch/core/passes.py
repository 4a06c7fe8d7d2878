"""Pass-manager layer over the streamline transforms (the compiler spine);
counterpart of the JAX package's ``core/passes.py``.

The paper's Fig. 4 failure is an *ordering* bug: FINN's tutorial step list
fuses MatMul+MultiThreshold before the stray NHWC→NCHW transposes are
absorbed, so the weights never reach the MVAU and the build silently
mis-maps.  This module turns that class of bug into a checkable error:

* every transform is registered as a :class:`GraphPass` with metadata —
  which structural **properties** it ``requires`` on the input graph and
  which it ``establishes`` on the output;
* properties are *predicates over the graph* (see ``PROPERTY_CHECKS``), so a
  precondition can never go stale: the PassManager re-derives it from
  structure right before the pass runs;
* :class:`PassManager` applies an ordered pass list, checking preconditions
  (→ :class:`PassOrderError`), optionally re-executing the graph on golden
  feeds after every pass (FINN-style per-pass verification,
  → :class:`PassVerificationError`), and recording a :class:`PassTrace`
  report of what each pass did.

Raw ``Graph -> Graph`` callables keep working everywhere a pass is accepted:
they are resolved to their registered metadata by function identity, or
wrapped as metadata-free passes, so a plain function can stand in a
pass list.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

from repro_torch.core import transforms as T
from repro_torch.core.graph import Graph, GraphBuildError, execute
from repro_torch.device import DeviceLike

__all__ = [
    "GraphPass",
    "PassManager",
    "PassOrderError",
    "PassVerificationError",
    "PassRecord",
    "PassTrace",
    "PASS_REGISTRY",
    "PROPERTY_CHECKS",
    "register_pass",
    "resolve_pass",
    "apply_pass",
]


class PassOrderError(GraphBuildError):
    """A pass ran before its structural preconditions held (Fig. 4 bug)."""


class PassVerificationError(GraphBuildError):
    """A pass changed the graph's input→output function (golden-IO check)."""


# ---------------------------------------------------------------------------
# Structural properties — predicates, not bookkeeping
# ---------------------------------------------------------------------------
def _prop_shape_inference(g: Graph) -> bool:
    """Every reduce_mean can resolve its spatial size (attr or annotation)."""
    return all(n.attrs.get("spatial_size") is not None
               or n.inputs[0] in g.shapes
               for n in g.nodes if n.op == "reduce_mean")


def _prop_trailing_axis_thresholds(g: Graph) -> bool:
    """No MultiThreshold reads per-channel thresholds on a non-trailing axis.

    This is exactly the state AbsorbTransposeIntoMultiThreshold establishes;
    fusing MVAUs while it is false reproduces the paper's mis-build (the
    stray Transpose blocks the weights from reaching the MVAU).
    """
    return all(n.attrs.get("channel_axis", -1) == -1
               for n in g.nodes if n.op == "multithreshold")


def _prop_no_reduce_mean(g: Graph) -> bool:
    return not any(n.op == "reduce_mean" for n in g.nodes)


def _prop_hw_mappable(g: Graph) -> bool:
    return all(n.op in T._HW_OPS for n in g.nodes)


def _prop_datatypes_annotated(g: Graph) -> bool:
    """Every node-output tensor carries a datatype annotation (spec or an
    explicit None-for-float) — exactly what InferDataTypes establishes.
    Integer lowering without this would guess bit-widths from convention,
    the config-level failure mode this layer exists to remove."""
    return all(t in g.dtypes for n in g.nodes for t in n.outputs)


def _prop_integer_datapath(g: Graph) -> bool:
    """No float-emulated quantized compute remains (mvau/multithreshold all
    lowered to their integer forms)."""
    return not any(n.op in ("mvau", "multithreshold") for n in g.nodes)


def _prop_integer_fused(g: Graph) -> bool:
    """No fusable integer structure remains: every matmul_int→threshold and
    threshold→threshold chain is collapsed, every foldable interior
    dequantize→quantize pair is a single integer requantize, and every
    surviving threshold table is sorted (binary-searchable).  Re-derived
    from structure via the same candidate enumeration the fusion pass
    drains, so the property and the pass cannot disagree."""
    from repro_torch.core import datatypes as _dt

    return not _dt._fusion_candidates(g)


PROPERTY_CHECKS: Dict[str, Callable[[Graph], bool]] = {
    "shape_inference": _prop_shape_inference,
    "trailing_axis_thresholds": _prop_trailing_axis_thresholds,
    "no_reduce_mean": _prop_no_reduce_mean,
    "hw_mappable": _prop_hw_mappable,
    "datatypes_annotated": _prop_datatypes_annotated,
    "integer_datapath": _prop_integer_datapath,
    "integer_fused": _prop_integer_fused,
}


# ---------------------------------------------------------------------------
# GraphPass + registry
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class GraphPass:
    """A named, metadata-carrying graph rewrite.

    ``requires`` / ``establishes`` name entries of ``PROPERTY_CHECKS``.
    ``requires`` is enforced before the pass runs; ``establishes`` is
    re-checked afterwards (a pass that fails to deliver its contract is a
    bug in the pass, reported loudly) and recorded on ``graph.properties``.
    """

    name: str
    fn: Callable[[Graph], Graph]
    description: str = ""
    requires: Tuple[str, ...] = ()
    establishes: Tuple[str, ...] = ()
    invalidates: Tuple[str, ...] = ()

    def __call__(self, g: Graph) -> Graph:
        return apply_pass(g, self)


PASS_REGISTRY: Dict[str, GraphPass] = {}
_BY_FN: Dict[Any, GraphPass] = {}


def register_pass(name: str, fn: Callable[[Graph], Graph], *,
                  description: str = "",
                  requires: Sequence[str] = (),
                  establishes: Sequence[str] = (),
                  invalidates: Sequence[str] = ()) -> GraphPass:
    for prop in tuple(requires) + tuple(establishes):
        if prop not in PROPERTY_CHECKS:
            raise ValueError(f"pass '{name}' references unknown property "
                             f"'{prop}' (known: {sorted(PROPERTY_CHECKS)})")
    p = GraphPass(name, fn, description, tuple(requires), tuple(establishes),
                  tuple(invalidates))
    PASS_REGISTRY[name] = p
    _BY_FN[fn] = p
    return p


PassLike = Union[str, GraphPass, Callable[[Graph], Graph]]


def resolve_pass(p: PassLike) -> GraphPass:
    if isinstance(p, GraphPass):
        return p
    if isinstance(p, str):
        if p not in PASS_REGISTRY:
            raise KeyError(f"unknown pass '{p}'; registered: "
                           f"{sorted(PASS_REGISTRY)}")
        return PASS_REGISTRY[p]
    if callable(p):
        # legacy call sites hand us the raw transform function; recover its
        # metadata by identity so old step lists get precondition checking
        return _BY_FN.get(p) or GraphPass(getattr(p, "__name__", "anonymous"), p)
    raise TypeError(f"cannot interpret {p!r} as a pass")


def _establisher_of(prop: str) -> Optional[str]:
    for p in PASS_REGISTRY.values():
        if prop in p.establishes:
            return p.name
    return None


def apply_pass(g: Graph, pass_like: PassLike, *, check: bool = True) -> Graph:
    """Apply one pass with precondition/postcondition checking."""
    p = resolve_pass(pass_like)
    if check:
        for prop in p.requires:
            if not PROPERTY_CHECKS[prop](g):
                hint = _establisher_of(prop)
                hint = f" (run '{hint}' first)" if hint else ""
                raise PassOrderError(
                    f"pass '{p.name}' on graph '{g.name}': precondition "
                    f"'{prop}' does not hold{hint} — this ordering would "
                    "silently mis-build (paper Fig. 4)")
    out = p.fn(g)
    if check:
        for prop in p.establishes:
            if not PROPERTY_CHECKS[prop](out):
                raise GraphBuildError(
                    f"pass '{p.name}' promised to establish '{prop}' but the "
                    f"output graph violates it — pass bug")
    # advisory annotation trail: which contracts have been delivered so far
    # (precondition checks never read this — they re-derive from structure)
    out.properties = (set(g.properties) | set(p.establishes)) - set(p.invalidates)
    return out


# ---------------------------------------------------------------------------
# Trace / report
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class PassRecord:
    name: str
    nodes_before: int
    nodes_after: int
    op_delta: Dict[str, int]          # op -> count change (only nonzero)
    duration_s: float
    verified: Optional[bool] = None   # None = no golden feeds supplied
    max_abs_err: Optional[float] = None


@dataclasses.dataclass
class PassTrace:
    graph_name: str
    records: List[PassRecord] = dataclasses.field(default_factory=list)

    @property
    def total_s(self) -> float:
        return sum(r.duration_s for r in self.records)

    def report(self) -> str:
        lines = [f"pass trace for '{self.graph_name}' "
                 f"({len(self.records)} passes, {self.total_s * 1e3:.1f} ms)"]
        for r in self.records:
            delta = ", ".join(f"{op}{n:+d}" for op, n in sorted(r.op_delta.items()))
            v = ("" if r.verified is None
                 else f"  io-verified(maxerr={r.max_abs_err:.2e})" if r.verified
                 else "  IO-MISMATCH")
            lines.append(f"  {r.name:40s} {r.nodes_before:3d}->"
                         f"{r.nodes_after:3d} nodes  {r.duration_s * 1e3:7.2f} ms"
                         f"  [{delta or 'no-op'}]{v}")
        return "\n".join(lines)


def op_histogram(g: Graph) -> Dict[str, int]:
    """``{op: count}`` over a graph's nodes (trace deltas, model reports)."""
    hist: Dict[str, int] = {}
    for n in g.nodes:
        hist[n.op] = hist.get(n.op, 0) + 1
    return hist


@dataclasses.dataclass
class BuildResult:
    graph: Graph
    trace: PassTrace


# ---------------------------------------------------------------------------
# PassManager
# ---------------------------------------------------------------------------
class PassManager:
    """Apply an ordered pass list with static + runtime ordering checks.

    ``run`` has value semantics: every transform copies before rewriting,
    so the caller's input graph is never mutated (tested).

    ``verify_feeds``: optional ``{input_name: array}`` golden feeds.  When
    given, the graph is executed after every pass and compared against the
    pre-pass outputs — FINN's per-transformation verification flow.  On the
    paper's exact fixed-point grids the comparison is exact to ``atol``.
    """

    def __init__(self, *, rtol: float = 1e-5, atol: float = 1e-6,
                 tracer: Optional[Any] = None, device: DeviceLike = None):
        self.rtol = rtol
        self.atol = atol
        if tracer is None:
            from repro_torch.obs import get_tracer
            tracer = get_tracer()
        self.tracer = tracer
        # where golden-IO verification executes the graph (None: the
        # device of the tensor feeds, else the card)
        self.device = device

    def validate(self, passes: Sequence[PassLike]) -> List[GraphPass]:
        """Static recipe check: a pass must not require a property that only
        a *later* pass in the same list establishes — that ordering can never
        be correct, whatever the input graph."""
        resolved = [resolve_pass(p) for p in passes]
        establishes_at: Dict[str, int] = {}
        for i, p in enumerate(resolved):
            for prop in p.establishes:
                establishes_at.setdefault(prop, i)
        for i, p in enumerate(resolved):
            for prop in p.requires:
                j = establishes_at.get(prop)
                if j is not None and j > i:
                    raise PassOrderError(
                        f"recipe lists '{p.name}' (position {i}) before "
                        f"'{resolved[j].name}' (position {j}), but "
                        f"'{p.name}' requires '{prop}' which only "
                        f"'{resolved[j].name}' establishes — reorder the "
                        "recipe (paper Sec. III-A: step lists are "
                        "architecture-dependent AND order-dependent)")
        return resolved

    def run(self, graph: Graph, passes: Sequence[PassLike], *,
            verify_feeds: Optional[Dict[str, Any]] = None) -> BuildResult:
        resolved = self.validate(passes)
        trace = PassTrace(graph.name)

        def outputs(g: Graph):
            return [o.cpu().numpy()
                    for o in execute(g, verify_feeds, self.device)]

        golden = outputs(graph) if verify_feeds is not None else None
        g = graph
        tr = self.tracer
        # Compiler telemetry (repro_torch.obs), as the reference's: one
        # "compile.build" root span per build, one "compile.pass" child per
        # pass — wall time, node/op deltas and verification verdicts on the
        # same trace spine the serving requests use.  A null span when
        # tracing is disabled.
        with tr.span("compile.build",
                     attrs={"graph": graph.name,
                            "n_passes": len(resolved),
                            "verified": verify_feeds is not None}) as root:
            for p in resolved:
                before = op_histogram(g)
                n_before = len(g.nodes)
                t0 = time.perf_counter()
                g = apply_pass(g, p)
                t1 = time.perf_counter()
                after = op_histogram(g)
                delta = {op: after.get(op, 0) - before.get(op, 0)
                         for op in set(before) | set(after)
                         if after.get(op, 0) != before.get(op, 0)}
                rec = PassRecord(p.name, n_before, len(g.nodes), delta,
                                 t1 - t0)
                if golden is not None:
                    outs = outputs(g)
                    err = max((float(np.max(np.abs(a - b))) if a.size
                               else 0.0) for a, b in zip(outs, golden))
                    rec.max_abs_err = err
                    rec.verified = bool(
                        all(np.allclose(a, b, rtol=self.rtol, atol=self.atol)
                            for a, b in zip(outs, golden)))
                if tr.enabled:
                    tr.record(
                        "compile.pass", t0, t1, trace=root.trace,
                        parent=root.span_id,
                        status=("ok" if rec.verified in (True, None)
                                else "io-mismatch"),
                        attrs={"pass": p.name,
                               "nodes_before": n_before,
                               "nodes_after": len(g.nodes),
                               "op_delta": delta,
                               "establishes": list(p.establishes),
                               "verified": rec.verified,
                               "max_abs_err": rec.max_abs_err})
                trace.records.append(rec)
                if rec.verified is False:
                    root.set("failed_pass", p.name)
                    raise PassVerificationError(
                        f"pass '{p.name}' changed graph semantics: max abs "
                        f"output error {err:.3e} exceeds "
                        f"rtol={self.rtol}/atol={self.atol}\n"
                        f"{trace.report()}")
            root.set("total_ms", trace.total_s * 1e3)
        return BuildResult(g, trace)


# ---------------------------------------------------------------------------
# Registered streamline passes (names are the recipe vocabulary)
# ---------------------------------------------------------------------------
register_pass(
    "convert_reduce_mean_to_gap", T.ConvertReduceMeanToGAP,
    description="reduce_mean -> GlobalAccPool + scalar Mul (Sec. III-D)",
    requires=("shape_inference",), establishes=("no_reduce_mean",))
register_pass(
    "absorb_transpose_into_multithreshold", T.AbsorbTransposeIntoMultiThreshold,
    description="Transpose->MT becomes trailing-axis MT->Transpose (Sec. III-C)",
    establishes=("trailing_axis_thresholds",))
register_pass(
    "cancel_transpose_pairs", T.CancelTransposePairs,
    description="delete identity Transpose pairs")
register_pass(
    "move_mul_past_matmul", T.MoveMulPastMatMul,
    description="push scalar scales past MatMul toward the output")
register_pass(
    "collapse_repeated_mul", T.CollapseRepeatedMul,
    description="merge scalar Mul chains")
register_pass(
    "fold_mul_into_multithreshold", T.FoldMulIntoMultiThreshold,
    description="absorb positive scales into threshold constants")
register_pass(
    "fuse_matmul_threshold_to_mvau", T.FuseMatMulThresholdToMVAU,
    description="MatMul + trailing-axis MultiThreshold -> fused MVAU",
    requires=("trailing_axis_thresholds",))
register_pass(
    "verify_hw_mappable", T.VerifyHWMappable,
    description="gate: every node must map to a HW layer",
    establishes=("hw_mappable",))

# datatype backbone (core/datatypes.py): annotation then integer lowering.
# Imported here (not at module top) to keep the pass/property tables free of
# a circular import — datatypes.py only depends on graph + quant.
from repro_torch.core import datatypes as DT  # noqa: E402

register_pass(
    "infer_datatypes", DT.InferDataTypes,
    description="propagate per-tensor FixedPointSpec annotations (FINN "
                "InferDataTypes): accumulator/threshold/GAP width rules",
    establishes=("datatypes_annotated",))
register_pass(
    "lower_to_integer_datapath", DT.LowerToIntegerDatapath,
    description="float-emulated HW graph -> integer datapath (quantized "
                "inputs, integer weight codes + thresholds, mvau_int)",
    requires=("datatypes_annotated",),
    establishes=("integer_datapath",))
register_pass(
    "fuse_integer_datapath", DT.FuseIntegerDatapath,
    description="collapse matmul_int/threshold chains into fused mvau_int, "
                "fold interior dequantize->quantize pairs into integer "
                "requantize, sort threshold tables (narrow codes end-to-end)",
    requires=("integer_datapath",),
    establishes=("integer_fused",))
