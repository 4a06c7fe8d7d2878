"""Per-node cost attribution for a :class:`DeployedModel`.

Counterpart of the JAX package's ``obs/costmodel.py``.
``profile_deployed(dm, example)`` walks the deployed HW graph with shapes
inferred for the given batch and produces one row per node:

* **flops** — analytic op count (matmul-family: ``2·|out|·K``; threshold
  ops: ``|out|·L`` compares against an L-level table; pools/elementwise:
  ``|out|``; pure data movement: 0);
* **bytes** — tensor traffic: inputs + outputs at their *storage* width
  (``graph.dtypes`` FixedPointSpec bits when annotated — packed int4 counts
  at 0.5 B/elem — else f32), initializers at their actual ``nbytes``;
* **est_ms** — single-node roofline bound, ``max(flops/peak, bytes/bw)``,
  with per-backend peak/bandwidth constants; on a backend with
  :data:`KERNEL_PEAK_OPS`, the peak is the one of the unit that the node's
  kernel runs on there (int8 tensor cores, int32 or float32 on the CUDA
  cores), read from its card dispatch label;
* **kernel** — the dispatch label from :meth:`DeployedModel.dispatch_table`.

The reference's optional ``xla`` totals (XLA's ``cost_analysis()``) have
no counterpart: ``xla=True`` raises.  The farm records ``totals.est_ms``
as ``modeled_ms`` per sweep point.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

from repro_torch.models.layers import not_ported

__all__ = ["BACKEND_ROOFLINE", "KERNEL_PEAK_OPS", "backend_of",
           "profile_deployed", "render_profile"]

# (peak operations/s, memory bandwidth B/s).  "h100": NVIDIA's published
# H100 SXM data sheet, dense rates at the 700 W power limit: HBM3 at 3.35
# TB/s, and float32 outside the tensor cores (67 TFLOP/s) for every node but
# those :data:`KERNEL_PEAK_OPS` names.  "gpu" (any other CUDA card) and
# "cpu" are the reference's generic ballparks.
BACKEND_ROOFLINE = {
    "h100": (67e12, 3.35e12),
    "gpu": (60e12, 1000e9),
    "cpu": (1e11, 2e10),
}

# Per backend, the peak of the unit a node's card dispatch label runs on.
# "h100": the integer MVAU on the int8 tensor cores at the data sheet's
# 1,979 TOP/s; on the CUDA cores (codes wider than int8) int32 multiply-add
# at half the float32 rate (64 INT32 lanes per SM against 128 FP32, Hopper
# white paper).
KERNEL_PEAK_OPS = {
    "h100": {"fused-cuda": 1979e12, "fused-cuda-core": 67e12 / 2},
}

_MATMUL_OPS = {"matmul", "matmul_int", "mvau", "mvau_int"}
_THRESHOLD_OPS = {"multithreshold", "multithreshold_int"}
_ELEMENTWISE_OPS = {"add", "mul", "quantize", "dequantize", "requantize",
                    "maxpool", "global_acc_pool"}


def backend_of(device: torch.device) -> str:
    """The roofline entry for a device: ``"h100"`` for an H100, ``"gpu"``
    for another CUDA card, ``"cpu"`` otherwise."""
    if device.type != "cuda":
        return "cpu"
    return "h100" if "H100" in torch.cuda.get_device_name(device) else "gpu"


def _numel(shape) -> float:
    n = 1.0
    for d in shape:
        n *= int(d)
    return n


def _elt_bytes(g, tensor: str) -> float:
    """Storage bytes per element: annotated fixed-point width when the
    datatype pass ran, f32 otherwise."""
    spec = g.dtypes.get(tensor)
    if spec is not None and getattr(spec, "total_bits", None):
        return spec.total_bits / 8.0
    return 4.0


def _tensor_bytes(g, tensor: str) -> float:
    if tensor in g.initializers:
        return float(np.asarray(g.initializers[tensor]).nbytes)
    shape = g.shapes.get(tensor)
    if shape is None:
        return 0.0
    return _numel(shape) * _elt_bytes(g, tensor)


def _node_flops(g, node) -> float:
    out_shape = g.shapes.get(node.outputs[0])
    if out_shape is None:
        return 0.0
    out_n = _numel(out_shape)
    if node.op in _MATMUL_OPS:
        in_shape = g.shapes.get(node.inputs[0])
        k = int(in_shape[-1]) if in_shape else 1
        return 2.0 * out_n * k
    if node.op in _THRESHOLD_OPS:
        t = node.inputs[-1]
        tshape = (g.shapes.get(t)
                  or np.shape(g.initializers.get(t, ())))
        levels = int(tshape[-1]) if tshape else 1
        return out_n * max(levels, 1)
    if node.op == "maxpool":
        k = int(node.attrs.get("kernel", 2))
        return out_n * k * k
    if node.op == "global_acc_pool":
        in_shape = g.shapes.get(node.inputs[0])
        return _numel(in_shape) if in_shape else out_n
    if node.op in _ELEMENTWISE_OPS:
        return out_n
    return 0.0  # movement / unknown: bandwidth-bound by construction


def profile_deployed(dm, example, *, xla: bool = True,
                     backend: Optional[str] = None) -> Dict[str, Any]:
    """Per-node FLOPs/bytes/estimated-ms table for one batch shape.

    ``example`` is a batched input (same contract as ``dm(example)``); its
    shapes are inferred by running the graph on zeros of that shape on the
    CPU (``Graph.infer_shapes``).  Returns ``{"batch", "backend", "nodes":
    [row...], "totals", "xla": None}``; rows carry ``share`` of the total
    modeled time and ``kernel`` from the live dispatch table.  ``backend``
    defaults to :func:`backend_of` the artifact's device.
    """
    from repro_torch.kernels import ops as kops

    if xla:
        raise not_ported("the XLA cost-analysis cross-check "
                         "(profile(xla=True))", "observability")
    be = backend or backend_of(dm.device)
    peak, bw = BACKEND_ROOFLINE.get(be, BACKEND_ROOFLINE["cpu"])

    g = dm.graph.copy()
    if len(dm.input_names) != 1:
        raise ValueError("profile_deployed supports single-input graphs")
    g.infer_shapes({dm.input_names[0]: example})
    kernels = {r["tensor"]: r["kernel"] for r in dm.dispatch_table()}
    unit_peaks = KERNEL_PEAK_OPS.get(be, {})
    folded = kops.folded_into(g.nodes, g.outputs)

    rows = []
    for node in g.nodes:
        flops = _node_flops(g, node)
        nbytes = (sum(_tensor_bytes(g, t) for t in node.inputs)
                  + sum(_tensor_bytes(g, t) for t in node.outputs))
        # the unit this node runs on on the backend's card, whatever
        # device the artifact itself lives on
        node_peak = unit_peaks.get(kops.kernel_dispatch(
            node, False, folded.get(node.outputs[0])), peak)
        est_ms = max(flops / node_peak, nbytes / bw) * 1e3
        rows.append({
            "tensor": node.outputs[0], "op": node.op,
            "kernel": kernels.get(node.outputs[0], "?"),
            "flops": flops, "bytes": nbytes, "est_ms": est_ms,
            "bound": ("compute" if flops / node_peak >= nbytes / bw
                      else "memory"),
        })

    total_ms = sum(r["est_ms"] for r in rows) or 1.0
    for r in rows:
        r["share"] = r["est_ms"] / total_ms
    totals = {
        "flops": sum(r["flops"] for r in rows),
        "bytes": sum(r["bytes"] for r in rows),
        "est_ms": sum(r["est_ms"] for r in rows),
    }
    shape = np.shape(example)
    return {"batch": int(shape[0]) if shape else 1, "backend": be,
            "nodes": rows, "totals": totals, "xla": None}


def render_profile(prof: Dict[str, Any], top: int = 0) -> str:
    """Human-readable attribution table (sorted by modeled share)."""
    rows = sorted(prof["nodes"], key=lambda r: -r["est_ms"])
    if top:
        rows = rows[:top]
    lines = [f"profile: batch={prof['batch']} backend={prof['backend']} "
             f"modeled {prof['totals']['est_ms']*1e3:.1f} us "
             f"({prof['totals']['flops']/1e6:.2f} MFLOP, "
             f"{prof['totals']['bytes']/1e6:.3f} MB)"]
    for r in rows:
        lines.append(
            f"  {r['share']*100:5.1f}%  {r['est_ms']*1e3:8.2f} us  "
            f"{r['flops']/1e6:9.3f} MF {r['bytes']/1e3:9.1f} kB "
            f"[{r['bound'][:3]}] {r['op']:18s} {r['kernel']:12s} "
            f"{r['tensor']}")
    return "\n".join(lines)
