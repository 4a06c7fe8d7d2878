"""Streamline / Convert-to-HW transformation passes (paper Sec. III-C/D).

Every pass is a pure ``Graph -> Graph`` rewrite whose output is
output-equivalent to its input.  Counterpart of the JAX package's
``core/transforms.py``, rewrite for rewrite (pure numpy and graph code), so
the two packages' streamlined graphs compare dump for dump.  The two passes the paper contributes —
``AbsorbTransposeIntoMultiThreshold`` and ``ConvertReduceMeanToGAP`` — are
implemented exactly as described; the rest are the supporting streamline
passes FINN applies around them (scale folding, transpose cancellation,
MVAU fusion).
"""

from __future__ import annotations

from typing import Callable, Sequence

import numpy as np

from repro_torch.core.graph import Graph, GraphBuildError, Node

Transform = Callable[[Graph], Graph]

__all__ = [
    "AbsorbTransposeIntoMultiThreshold",
    "ConvertReduceMeanToGAP",
    "CancelTransposePairs",
    "CollapseRepeatedMul",
    "MoveMulPastMatMul",
    "FoldMulIntoMultiThreshold",
    "FuseMatMulThresholdToMVAU",
    "VerifyHWMappable",
    "apply_transforms",
]

_NCHW_TO_NHWC = (0, 2, 3, 1)
_NHWC_TO_NCHW = (0, 3, 1, 2)


# ---------------------------------------------------------------------------
# Paper Sec. III-C — Transpose Node Optimization
# ---------------------------------------------------------------------------
def AbsorbTransposeIntoMultiThreshold(g: Graph) -> Graph:
    """Merge ``Transpose(NHWC→NCHW) → MultiThreshold`` into a trailing-axis
    MultiThreshold followed by a re-emitted Transpose.

    The Conv-lowered MatMul produces NHWC, while MultiThreshold (imported
    from the NCHW PyTorch world) expects channels at axis 1; the stray
    Transpose in between "prevented the proper transfer of weights to the
    MVAU".  After this pass the threshold node reads the MatMul output
    *directly* (channels trailing — exactly what the MVAU streams), and the
    transpose moves after it, where CancelTransposePairs can usually delete
    it against the next Conv's NHWC-ingest transpose.
    """
    g = g.copy()
    changed = True
    while changed:
        changed = False
        for node in list(g.nodes):
            if node.op != "transpose" or tuple(node.attrs["perm"]) != _NHWC_TO_NCHW:
                continue
            consumers = g.consumers(node.outputs[0])
            if len(consumers) != 1 or consumers[0].op != "multithreshold":
                continue
            mt = consumers[0]
            # only absorb MTs explicitly marked NCHW (axis 1); a missing
            # attr means trailing-axis (the interpreter's default), and
            # rewiring those would change semantics
            if mt.attrs.get("channel_axis", -1) != 1:
                continue
            # Rewire: MT reads the transpose's input with trailing channels;
            # a new transpose after MT restores NCHW for downstream users.
            mt_out = mt.outputs[0]
            new_mt_out = g.fresh_name(mt_out + "_nhwc")
            g.set_input(mt, 0, node.inputs[0])
            mt.attrs["channel_axis"] = -1
            g.set_output(mt, 0, new_mt_out)
            post = Node("transpose", [new_mt_out], [mt_out],
                        {"perm": list(_NHWC_TO_NCHW)})
            g.insert_after(mt, post)
            g.remove_node(node)
            changed = True
            break
    g.toposort()
    return g


# ---------------------------------------------------------------------------
# Paper Sec. III-D — Reduce Mean and GAP Handling
# ---------------------------------------------------------------------------
def ConvertReduceMeanToGAP(g: Graph) -> Graph:
    """Rewrite spatial ``reduce_mean`` → ``GlobalAccPool`` + scalar ``Mul``.

    GlobalAccPool "computes the cumulative sum along the spatial dimensions
    ... Instead of performing division within the class itself, it outputs
    the cumulative sum as is", with the averaging recovered by a scalar Mul —
    "avoiding the computationally intensive division operation".  The Mul is
    a scale that later passes fold into thresholds or the NCM classifier.
    """
    g = g.copy()
    for node in list(g.nodes):
        if node.op != "reduce_mean":
            continue
        axes = tuple(node.attrs["axes"])
        hw = node.attrs.get("spatial_size")
        if hw is None and node.inputs[0] in g.shapes:
            # fall back to the shape annotations from Graph.infer_shapes()
            in_shape = g.shapes[node.inputs[0]]
            hw = int(np.prod([in_shape[a] for a in axes]))
        if hw is None:
            raise GraphBuildError(
                "reduce_mean lacks spatial_size attr; shape inference must "
                "run before ConvertReduceMeanToGAP")
        acc_out = g.fresh_name(node.outputs[0] + "_accsum")
        # carry the spatial size onto the GAP node: the datatype-inference
        # GAP rule (sum width = in_bits + ceil(log2 H*W)) needs it, and
        # re-deriving would require shapes the streamlined graph may lack
        gap = Node("global_acc_pool", [node.inputs[0]], [acc_out],
                   {"axes": list(axes), "spatial_size": int(hw)})
        mul = Node("mul", [acc_out], [node.outputs[0]], {"value": 1.0 / float(hw)})
        i = g.nodes.index(node)
        g.remove_node(node)
        g.insert_node(i, gap)
        g.insert_node(i + 1, mul)
    g.toposort()
    return g


# ---------------------------------------------------------------------------
# Supporting streamline passes
# ---------------------------------------------------------------------------
def CancelTransposePairs(g: Graph) -> Graph:
    """Delete ``Transpose(p) → Transpose(q)`` when q∘p is the identity."""
    g = g.copy()
    changed = True
    while changed:
        changed = False
        for node in list(g.nodes):
            if node.op != "transpose":
                continue
            consumers = g.consumers(node.outputs[0])
            if len(consumers) != 1 or consumers[0].op != "transpose":
                continue
            nxt = consumers[0]
            p, q = node.attrs["perm"], nxt.attrs["perm"]
            comp = [p[qi] for qi in q]
            if comp != list(range(len(comp))):
                continue
            # rewire consumers of nxt's output straight to node's input
            src = node.inputs[0]
            for c in g.consumers(nxt.outputs[0]):
                for pos, i in enumerate(c.inputs):
                    if i == nxt.outputs[0]:
                        g.set_input(c, pos, src)
            g.outputs = [src if o == nxt.outputs[0] else o for o in g.outputs]
            g.remove_node(node)
            g.remove_node(nxt)
            changed = True
            break
    g.toposort()
    return g


def CollapseRepeatedMul(g: Graph) -> Graph:
    """Merge chains of scalar Muls into one (scale accumulation)."""
    g = g.copy()
    changed = True
    while changed:
        changed = False
        for node in list(g.nodes):
            if node.op != "mul" or "value" not in node.attrs:
                continue
            consumers = g.consumers(node.outputs[0])
            if len(consumers) != 1 or consumers[0].op != "mul" \
                    or "value" not in consumers[0].attrs:
                continue
            nxt = consumers[0]
            nxt.attrs["value"] = float(nxt.attrs["value"]) * float(node.attrs["value"])
            g.set_input(nxt, 0, node.inputs[0])
            g.remove_node(node)
            changed = True
            break
    g.toposort()
    return g


def MoveMulPastMatMul(g: Graph) -> Graph:
    """``Mul(c) → MatMul`` ⇒ ``MatMul → Mul(c)`` (linearity), so scales drift
    toward the output where FoldMulIntoMultiThreshold can absorb them."""
    g = g.copy()
    changed = True
    while changed:
        changed = False
        for node in list(g.nodes):
            if node.op != "mul" or "value" not in node.attrs:
                continue
            consumers = g.consumers(node.outputs[0])
            if len(consumers) != 1 or consumers[0].op != "matmul":
                continue
            mm = consumers[0]
            if mm.inputs[0] != node.outputs[0] or len(mm.inputs) > 2:
                continue  # only the activation operand; biased matmul not linear
            mm_out = mm.outputs[0]
            new_out = g.fresh_name(mm_out + "_prescale")
            g.set_input(mm, 0, node.inputs[0])
            g.set_output(mm, 0, new_out)
            g.set_input(node, 0, new_out)
            g.set_output(node, 0, mm_out)
            g.remove_node(node)
            g.insert_after(mm, node)
            changed = True
            break
    g.toposort()
    return g


def FoldMulIntoMultiThreshold(g: Graph) -> Graph:
    """``Mul(c>0) → MultiThreshold(T)`` ⇒ ``MultiThreshold(T/c)``.

    This is how the GAP 1/(H·W) scale (Sec. III-D) disappears from the
    datapath entirely: thresholds are compile-time constants.
    """
    g = g.copy()
    changed = True
    while changed:
        changed = False
        for node in list(g.nodes):
            if node.op != "mul" or "value" not in node.attrs:
                continue
            c = float(node.attrs["value"])
            if c <= 0:
                continue
            consumers = g.consumers(node.outputs[0])
            if len(consumers) != 1 or consumers[0].op != "multithreshold":
                continue
            mt = consumers[0]
            tname = mt.inputs[1]
            g.initializers[tname] = (np.asarray(g.initializers[tname]) / c
                                     ).astype(np.float32)
            g.set_input(mt, 0, node.inputs[0])
            g.remove_node(node)
            changed = True
            break
    g.toposort()
    return g


# ---------------------------------------------------------------------------
# Convert-to-HW-Layer (MVAU fusion) + mappability gate
# ---------------------------------------------------------------------------
def FuseMatMulThresholdToMVAU(g: Graph) -> Graph:
    """``MatMul → MultiThreshold(trailing-axis)`` ⇒ fused ``mvau`` node.

    This only fires for *trailing-axis* thresholds — i.e. after
    AbsorbTransposeIntoMultiThreshold has run.  That ordering dependency is
    the paper's Fig. 4 story: without the absorb pass the stray Transpose
    sits between MatMul and MultiThreshold and the weights never reach the
    MVAU.
    """
    g = g.copy()
    changed = True
    while changed:
        changed = False
        for node in list(g.nodes):
            if node.op != "matmul" or len(node.inputs) != 2:
                continue
            consumers = g.consumers(node.outputs[0])
            if len(consumers) != 1 or consumers[0].op != "multithreshold":
                continue
            mt = consumers[0]
            # missing channel_axis means trailing (the interpreter's default
            # in _ex_multithreshold) — keep the fuse gate consistent with
            # execution semantics and the trailing_axis_thresholds predicate
            if mt.attrs.get("channel_axis", -1) not in (-1,):
                continue
            fused = Node(
                "mvau",
                [node.inputs[0], node.inputs[1], mt.inputs[1]],
                [mt.outputs[0]],
                {k: mt.attrs[k] for k in ("out_base", "out_scale", "out_bias")
                 if k in mt.attrs},
            )
            i = g.nodes.index(node)
            g.remove_node(node)
            g.remove_node(mt)
            g.insert_node(i, fused)
            changed = True
            break
    g.toposort()
    return g


_HW_OPS = {"im2col", "mvau", "mvau_int", "matmul_int", "multithreshold_int",
           "requantize", "quantize", "dequantize",
           "transpose", "maxpool", "global_acc_pool",
           "mul", "add", "flatten", "matmul"}


def VerifyHWMappable(g: Graph) -> Graph:
    """The build gate: every remaining node must map to a HW layer.

    ``reduce_mean`` or non-absorbed ``multithreshold`` here reproduces the
    paper's failure mode ("the build steps provided in FINN's tutorial ...
    cannot be directly applied to other architectures").
    """
    bad = [n.op for n in g.nodes if n.op not in _HW_OPS]
    if bad:
        raise GraphBuildError(
            f"graph '{g.name}' is not HW-mappable; offending ops: {sorted(set(bad))}. "
            "Architecture-dependent streamline steps are missing (paper Sec. III-A).")
    return g


def apply_transforms(g: Graph, passes: Sequence[Transform]) -> Graph:
    """Apply bare transforms in order (the reference's deprecated helper;
    :class:`~repro_torch.core.passes.PassManager` is the checked path)."""
    for p in passes:
        g = p(g)
    return g
