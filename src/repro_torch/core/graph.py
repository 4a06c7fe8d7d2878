"""A small FINN-like dataflow-graph IR + PyTorch interpreter.

Counterpart of the JAX package's ``core/graph.py``: the same IR (nodes,
named tensors, numpy initializers, layout attrs), the same mutators and
adjacency index, and an interpreter whose executors are PyTorch ops.  The
passes in :mod:`repro_torch.core.transforms` rewrite it exactly as the
reference's rewrite its graph, so the two streamlined graphs compare dump
for dump.

Ops (all the paper's ResNet-9 needs, the fused HW ops, and the decoder
LM's decode step):

=================  ==========================================================
``im2col``         patch extraction (the FINN lowering of Conv)
``matmul``         A @ W (+ bias); weights are graph initializers
``multithreshold`` FINN activation quantization: ``base + Σ 1[x ≥ Tᵢ]``
``transpose``      explicit layout permutation (NCHW↔NHWC)
``reduce_mean``    spatial mean — *not* HW-mappable; must be streamlined away
``global_acc_pool``FINN's GlobalAccPool: integer spatial **sum** (no divide)
``mul`` / ``add``  scalar/elementwise affine (scales get folded by passes)
``maxpool``        2×2 window max
``mvau``           fused matmul+multithreshold — the CUDA MVAU kernel
``embed``          token-id row gather (the LM's embedding table)
``rmsnorm``        RMS normalization (float, between quantizers)
``silu``/``gelu``  smooth activations (float)
``attn_decode``    one causal decode step over a fixed-capacity KV cache
``attn_prefill``   causal self-attention over a whole prompt
=================  ==========================================================
"""

from __future__ import annotations

import collections
import dataclasses
from typing import Any, Callable, Dict, List, Optional, Set, Tuple

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device

__all__ = ["Node", "Graph", "execute", "GraphBuildError", "set_index_enabled"]


class GraphBuildError(RuntimeError):
    """A graph reached the HW-mapping stage with non-mappable nodes."""


# Escape hatch for benchmarking the cached index against the linear scans
# (the reference's benchmarks flip it) — not for production use.
_INDEX_ENABLED = True


def set_index_enabled(enabled: bool) -> None:
    global _INDEX_ENABLED
    _INDEX_ENABLED = bool(enabled)


@dataclasses.dataclass
class Node:
    op: str
    inputs: List[str]
    outputs: List[str]
    attrs: Dict[str, Any] = dataclasses.field(default_factory=dict)

    def copy(self) -> "Node":
        return Node(self.op, list(self.inputs), list(self.outputs), dict(self.attrs))


@dataclasses.dataclass
class Graph:
    nodes: List[Node]
    inputs: List[str]
    outputs: List[str]
    initializers: Dict[str, np.ndarray] = dataclasses.field(default_factory=dict)
    name: str = "graph"
    # Verified structural properties (tokens such as
    # "trailing_axis_thresholds") — maintained by the PassManager, advisory
    # for humans; precondition checks always re-derive from structure.
    properties: Set[str] = dataclasses.field(default_factory=set)
    # Optional tensor-shape annotations, filled by infer_shapes().
    shapes: Dict[str, Tuple[int, ...]] = dataclasses.field(default_factory=dict)
    # Per-tensor fixed-point datatype annotations (FixedPointSpec or None for
    # float tensors), keyed by tensor name.  Seeded by exporters (graph
    # inputs / weight initializers), propagated to every tensor by the
    # ``infer_datatypes`` pass (core/datatypes.py).  The structured mutators
    # below keep the map coherent under rewiring; like ``shapes`` it is an
    # annotation — passes that need it re-derive via infer_datatypes.
    dtypes: Dict[str, Any] = dataclasses.field(default_factory=dict)
    _cache: Optional[Dict[str, Any]] = dataclasses.field(
        default=None, init=False, repr=False, compare=False)

    def copy(self) -> "Graph":
        g = Graph([n.copy() for n in self.nodes], list(self.inputs),
                  list(self.outputs), dict(self.initializers), self.name,
                  set(self.properties), dict(self.shapes), dict(self.dtypes))
        return g

    # -- cached adjacency index --------------------------------------------
    def invalidate(self) -> None:
        """Drop the producer/consumer index.  Call after mutating node
        wiring *directly*; the structured mutators below (``set_input``,
        ``remove_node``, ``insert_node``, ...) maintain the index
        incrementally and do NOT require it."""
        self._cache = None

    # -- structured mutators (keep the adjacency index valid in O(1)) -------
    def set_input(self, node: Node, pos: int, tensor: str) -> None:
        old = node.inputs[pos]
        node.inputs[pos] = tensor
        c = self._cache
        if c is not None and old != tensor:
            lst = c["cons"].get(old)
            if lst and node in lst:
                lst.remove(node)            # one occurrence per position
            c["cons"].setdefault(tensor, []).append(node)
            c["names"].add(tensor)

    def set_output(self, node: Node, pos: int, tensor: str) -> None:
        old = node.outputs[pos]
        node.outputs[pos] = tensor
        if old != tensor and old in self.dtypes and tensor not in self.dtypes:
            # the renamed tensor carries the same values — the annotation
            # follows it (the old name usually gets re-produced by a
            # value-preserving node the caller inserts next)
            self.dtypes[tensor] = self.dtypes[old]
        c = self._cache
        if c is not None and old != tensor:
            if c["prod"].get(old) is node:
                del c["prod"][old]
            c["prod"][tensor] = node
            c["names"].add(tensor)

    def remove_node(self, node: Node) -> None:
        self.nodes.remove(node)
        c = self._cache
        if c is not None:
            for t in node.outputs:
                if c["prod"].get(t) is node:
                    del c["prod"][t]
            for t in node.inputs:
                lst = c["cons"].get(t)
                if lst and node in lst:
                    lst.remove(node)
        for t in node.outputs:
            if self.producer(t) is None and t not in self.initializers \
                    and t not in self.inputs:
                self.dtypes.pop(t, None)    # tensor ceased to exist

    def insert_node(self, pos: int, node: Node) -> None:
        self.nodes.insert(pos, node)
        c = self._cache
        if c is not None:
            for t in node.outputs:
                c["prod"][t] = node
                c["names"].add(t)
            for t in node.inputs:
                c["cons"].setdefault(t, []).append(node)
                c["names"].add(t)

    def insert_after(self, ref: Node, node: Node) -> None:
        self.insert_node(self.nodes.index(ref) + 1, node)

    def _index(self) -> Optional[Dict[str, Any]]:
        if not _INDEX_ENABLED:
            return None
        if self._cache is None:
            prod: Dict[str, Node] = {}
            cons: Dict[str, List[Node]] = {}
            names: Set[str] = set(self.initializers)
            for n in self.nodes:
                for t in n.outputs:
                    prod[t] = n
                    names.add(t)
                for t in n.inputs:
                    cons.setdefault(t, []).append(n)
                    names.add(t)
            self._cache = {"prod": prod, "cons": cons, "names": names}
        return self._cache

    # -- small query helpers used by the transform passes -------------------
    def producer(self, tensor: str) -> Optional[Node]:
        idx = self._index()
        if idx is not None:
            return idx["prod"].get(tensor)
        for n in self.nodes:
            if tensor in n.outputs:
                return n
        return None

    def consumers(self, tensor: str) -> List[Node]:
        idx = self._index()
        if idx is None:
            return [n for n in self.nodes if tensor in n.inputs]
        # the index stores one entry per consuming *position* (so the
        # mutators can retire occurrences one at a time); de-dup here so a
        # node reading the same tensor twice is reported once, exactly like
        # the linear scan
        seen, out = set(), []
        for n in idx["cons"].get(tensor, ()):
            if id(n) not in seen:
                seen.add(id(n))
                out.append(n)
        return out

    def fresh_name(self, stem: str) -> str:
        idx = self._index()
        if idx is not None:
            taken = idx["names"]
        else:
            taken = set(self.initializers)
            for n in self.nodes:
                taken.update(n.inputs)
                taken.update(n.outputs)
        i = 0
        while f"{stem}_{i}" in taken:
            i += 1
        return f"{stem}_{i}"

    def toposort(self) -> None:
        """Re-order ``nodes`` topologically (Kahn's algorithm, O(V+E))."""
        avail = set(self.inputs) | set(self.initializers)
        indeg: Dict[int, int] = {}
        waiting: Dict[str, List[Node]] = {}
        ready: collections.deque = collections.deque()
        for n in self.nodes:
            d = 0
            for i in n.inputs:
                if i not in avail:
                    d += 1
                    waiting.setdefault(i, []).append(n)
            indeg[id(n)] = d
            if d == 0:
                ready.append(n)
        ordered: List[Node] = []
        while ready:
            n = ready.popleft()
            ordered.append(n)
            for t in n.outputs:
                if t in avail:
                    continue
                avail.add(t)
                for c in waiting.get(t, ()):
                    indeg[id(c)] -= 1
                    if indeg[id(c)] == 0:
                        ready.append(c)
        if len(ordered) != len(self.nodes):
            missing = {i for n in self.nodes if indeg[id(n)] > 0
                       for i in n.inputs if i not in avail}
            raise GraphBuildError(f"graph has unsatisfiable inputs: {missing}")
        self.nodes = ordered
        self.invalidate()

    # -- pass-manager integration -------------------------------------------
    def transform(self, pass_like, **kwargs) -> "Graph":
        """Apply one registered pass (by name, GraphPass, or raw callable),
        with its preconditions checked.  Returns the rewritten graph."""
        from repro_torch.core.passes import apply_pass

        return apply_pass(self, pass_like, **kwargs)

    def infer_shapes(self, feeds: Dict[str, Any]) -> "Graph":
        """Annotate ``self.shapes`` for every tensor.

        PyTorch has no abstract evaluation of this interpreter, so the graph
        runs once on zero tensors of the feeds' shapes on the CPU: call it
        at small shapes.  ``feeds`` maps graph inputs to arrays or tensors.
        """
        zeros = {k: torch.zeros(tuple(np.shape(v)),
                                dtype=(v.dtype if isinstance(v, torch.Tensor)
                                       else torch.float32))
                 for k, v in feeds.items()}
        env = _run(self, zeros, torch.device("cpu"), keep_all=True)
        self.shapes = {nm: tuple(v.shape) for nm, v in env.items()}
        return self


# ---------------------------------------------------------------------------
# Interpreter
# ---------------------------------------------------------------------------
def _ex_im2col(node: Node, x: torch.Tensor) -> torch.Tensor:
    """NHWC patch extraction -> (N, OH, OW, KH*KW*C), patch order
    (kh, kw, c).  FINN's Conv lowering."""
    from repro_torch.kernels import ref

    return ref.im2col(x, node.attrs["kernel"], node.attrs["stride"],
                      node.attrs["pad"])


def _ex_matmul(node: Node, x: torch.Tensor, w: torch.Tensor,
               b: Optional[torch.Tensor] = None) -> torch.Tensor:
    if x.is_cuda:
        from repro_torch.device import ieee_f32

        ieee_f32()
    y = torch.matmul(x, w)
    if b is not None:
        y = y + b
    return y


def _ex_multithreshold(node: Node, x: torch.Tensor,
                       t: torch.Tensor) -> torch.Tensor:
    from repro_torch.core import quant

    axis = node.attrs.get("channel_axis", -1)
    args = (node.attrs.get("out_base", 0), node.attrs.get("out_scale", 1.0),
            node.attrs.get("out_bias", 0.0), node.attrs.get("sorted_levels"))
    if t.ndim == 2 and axis not in (-1, x.ndim - 1):
        # Per-channel thresholds on a non-trailing axis: legal in the IR (the
        # NCHW case the paper's pass removes) — move channels last,
        # threshold, move back.
        xt = torch.movedim(x, axis, -1)
        return torch.movedim(quant.multithreshold(xt, t, *args), -1, axis)
    return quant.multithreshold(x, t, *args)


def _ex_mvau(node: Node, x: torch.Tensor, w: torch.Tensor,
             t: torch.Tensor) -> torch.Tensor:
    """Fused matmul+threshold — the MVAU kernel on the card, its plain
    version on the CPU."""
    from repro_torch.kernels import ops as kops

    return kops.mvau(
        x, w, t,
        out_base=node.attrs.get("out_base", 0),
        out_scale=node.attrs.get("out_scale", 1.0),
        out_bias=node.attrs.get("out_bias", 0.0))


# -- integer-datapath ops (emitted by core.datatypes.LowerToIntegerDatapath) --
def _ex_quantize(node: Node, x: torch.Tensor) -> torch.Tensor:
    """Real → integer codes at the node's annotated spec (int32 codes)."""
    from repro_torch.core import quant

    spec = quant.FixedPointSpec(node.attrs["bits"], node.attrs["frac_bits"],
                                node.attrs.get("signed", True))
    return quant.quantize(x, spec)


def _ex_dequantize(node: Node, q: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * float(np.float32(node.attrs["scale"]))


def _ex_mvau_int(node: Node, x: torch.Tensor, w: torch.Tensor,
                 t: torch.Tensor) -> torch.Tensor:
    """Integer MVAU: code × code matmul, int32 accumulate, int thresholds."""
    from repro_torch.core import quant
    from repro_torch.kernels import ref

    if node.attrs.get("w_packed"):
        w = quant.unpack_int4(w)
    return ref.mvau_int(x, w, t, out_base=node.attrs.get("out_base", 0))


def _ex_matmul_int(node: Node, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Bare integer-code matmul (int32 accumulate) — the pre-fusion form."""
    from repro_torch.core import quant
    from repro_torch.kernels import ref

    if node.attrs.get("w_packed"):
        w = quant.unpack_int4(w)
    return ref.matmul_int(x, w)


def _ex_multithreshold_int(node: Node, x: torch.Tensor,
                           t: torch.Tensor) -> torch.Tensor:
    from repro_torch.kernels import ref

    return ref.multithreshold_int(x, t, out_base=node.attrs.get("out_base", 0))


def _ex_requantize(node: Node, q: torch.Tensor) -> torch.Tensor:
    """Exact integer regrid (shift + round-half-even + clip)."""
    from repro_torch.kernels import ref

    return ref.requantize(q, node.attrs["shift"], node.attrs["bits"],
                          node.attrs["frac_bits"],
                          node.attrs.get("signed", True))


def _ex_gap(node: Node, x: torch.Tensor) -> torch.Tensor:
    axes = tuple(node.attrs["axes"])
    if not x.dtype.is_floating_point:
        # sub-int32 codes must not wrap, and torch.sum of integers returns
        # int64: sum in int32 semantics, hand back int32 as the reference
        return torch.sum(x.to(torch.int32), dim=axes).to(torch.int32)
    return torch.sum(x, dim=axes)


# -- decode-workload ops (models.lm's decode and prefill export) -------------
# The interpreter, the lowered model and ``models.lm.decode_step_ref`` call
# the same function for each: the decode chain is bit for bit only so.
def _ex_embed(node: Node, table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """Token-id row gather.  After integer lowering the table holds codes
    (packed int4 when ``w_packed``); gathering codes then dequantizing is
    bit for bit the float gather."""
    out = table[ids.long()]
    if node.attrs.get("w_packed"):
        from repro_torch.core import quant

        out = quant.unpack_int4(out)
    return out


def _ex_rmsnorm(node: Node, x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    from repro_torch.models import layers as L

    return L.rmsnorm({"g": g}, x, node.attrs.get("eps", 1e-6))


def _ex_silu(node: Node, x: torch.Tensor) -> torch.Tensor:
    from repro_torch.models import layers as L

    return L.silu(x)


def _ex_gelu(node: Node, x: torch.Tensor) -> torch.Tensor:
    from repro_torch.models import layers as L

    return L.gelu_tanh(x)


def _ex_attn_decode(node: Node, q, k_new, v_new, k_cache, v_cache, pos):
    from repro_torch.kernels import ref

    return ref.attn_decode(q, k_new, v_new, k_cache, v_cache, pos,
                           node.attrs["heads"])


def _ex_attn_prefill(node: Node, q, k, v):
    from repro_torch.kernels import ref

    return ref.attn_prefill(q, k, v, node.attrs["heads"])


def _maxpool(node: Node, x: torch.Tensor) -> torch.Tensor:
    k = node.attrs.get("kernel", 2)
    n, h, w, c = x.shape
    x = x[:, : h - h % k, : w - w % k, :]        # odd edges are cropped
    x = x.reshape(n, h // k, k, w // k, k, c)
    return torch.amax(x, dim=(2, 4))


_EXECUTORS: Dict[str, Callable[..., torch.Tensor]] = {
    "im2col": _ex_im2col,
    "matmul": _ex_matmul,
    "multithreshold": _ex_multithreshold,
    "mvau": _ex_mvau,
    "mvau_int": _ex_mvau_int,
    "matmul_int": _ex_matmul_int,
    "multithreshold_int": _ex_multithreshold_int,
    "requantize": _ex_requantize,
    "quantize": _ex_quantize,
    "dequantize": _ex_dequantize,
    "transpose": lambda node, x: torch.permute(x, tuple(node.attrs["perm"])),
    "reduce_mean": lambda node, x: torch.mean(x, dim=tuple(node.attrs["axes"])),
    "global_acc_pool": _ex_gap,
    "mul": lambda node, x, c=None: x * (node.attrs["value"] if c is None else c),
    "add": lambda node, a, b=None: a + (node.attrs["value"] if b is None else b),
    "maxpool": _maxpool,
    "relu": lambda node, x: torch.clamp_min(x, 0),
    "flatten": lambda node, x: x.reshape(x.shape[0], -1),
    "embed": _ex_embed,
    "rmsnorm": _ex_rmsnorm,
    "silu": _ex_silu,
    "gelu": _ex_gelu,
    "attn_decode": _ex_attn_decode,
    "attn_prefill": _ex_attn_prefill,
}


def as_tensor(v: Any, device: torch.device) -> torch.Tensor:
    """numpy array / tensor / scalar -> tensor on ``device`` (numpy dtypes
    keep their width: int8 weight codes stay int8)."""
    if isinstance(v, torch.Tensor):
        return v.to(device)
    # a copy: initializers may be read-only numpy views, which PyTorch
    # cannot wrap without sharing writable memory
    return torch.as_tensor(np.array(v, copy=True), device=device)


def _run(graph: Graph, feeds: Dict[str, torch.Tensor], device: torch.device,
         keep_all: bool = False) -> Dict[str, torch.Tensor]:
    env: Dict[str, torch.Tensor] = {k: as_tensor(v, device)
                                    for k, v in graph.initializers.items()}
    env.update({k: as_tensor(v, device) for k, v in feeds.items()})
    for node in graph.nodes:
        fn = _EXECUTORS.get(node.op)
        if fn is None:
            raise GraphBuildError(f"no executor for op '{node.op}'")
        out = fn(node, *[env[i] for i in node.inputs])
        outs = out if isinstance(out, (tuple, list)) else (out,)
        for name, val in zip(node.outputs, outs):
            env[name] = val
    return env


def _feeds_device(feeds: Dict[str, Any], device: DeviceLike) -> torch.device:
    """The device to run on: the one asked for, else that of the tensor
    feeds, else the card (which raises without one)."""
    if device is not None:
        return resolve_device(device)
    for v in feeds.values():
        if isinstance(v, torch.Tensor):
            return resolve_device(v.device)
    return resolve_device(None)


def execute(graph: Graph, feeds: Dict[str, Any],
            device: DeviceLike = None) -> List[torch.Tensor]:
    """Run the graph; returns the output tensors in ``graph.outputs`` order.

    The per-node *interpreter*: each op dispatches eagerly, so any
    intermediate tensor can be inspected by name.  It runs on ``device``,
    else on the device of the tensor feeds, else on the card.
    """
    dev = _feeds_device(feeds, device)
    with torch.no_grad():
        env = _run(graph, feeds, dev)
    return [env[o] for o in graph.outputs]
