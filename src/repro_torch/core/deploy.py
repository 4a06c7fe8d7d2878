"""``repro_torch.compile()`` — lower a QAT graph to a deployment artifact on
the card.

Counterpart of the JAX package's ``core/deploy.py``: pick a
:class:`BuildRecipe`, stream the graph through the :class:`PassManager`,
then lower the HW-mapped graph to one callable:

* initializers (integer weight codes, threshold tables) move to the device
  once, at compile time;
* each node dispatches through the kernel table of
  :func:`repro_torch.kernels.ops.graph_op_impls` (the CUDA MVAU and
  GlobalAccPool kernels on the card, their plain versions on the CPU) or
  the interpreter executors for pure data-movement ops.

Where the reference AOT-compiles one executable per padded batch bucket,
``warmup`` on the card captures each bucket as one CUDA graph (the whole
network's launches over a static input buffer;
:class:`repro_torch.core.cudagraph.GraphTable`), and ``batched`` /
``__call__`` on a warmed shape replay it: one ``cudaGraphLaunch`` instead of
a Python dispatch per node.  ``trace_count`` counts captures plus the
distinct shapes run eagerly, and stays flat after ``warmup`` as the
reference's retrace counter does.  On the CPU ``warmup`` runs each bucket
once eagerly: that is the port's CPU path.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch.core import recipes as R
from repro_torch.core.cudagraph import GraphTable
from repro_torch.core.graph import _EXECUTORS, Graph, GraphBuildError, as_tensor
from repro_torch.core.passes import PassManager, PassTrace
from repro_torch.device import DeviceLike, resolve_device

__all__ = ["DeployedModel", "bucket_for", "compile", "lower_graph",
           "normalize_buckets", "pow2_buckets"]


def lower_graph(graph: Graph, device: DeviceLike = None,
                fold_pools: bool = True) -> Callable:
    """Close a (streamlined) graph over its initializers, moved to
    ``device`` once, and return a ``(*inputs) -> tuple(outputs)`` function.

    Nodes are folded into one step where the shapes of the graph allow,
    and their outputs never enter the environment:

    * each ``im2col`` that :func:`repro_torch.kernels.ops.conv_pairs` pairs
      with its ``mvau`` or ``mvau_int``: one conv-form MVAU call on the
      im2col node's input, so the patch tensor never exists;
    * each tail ``im2col -> mvau_int -> add -> global_acc_pool`` that
      :func:`repro_torch.kernels.ops.gap_tails` matches: one call of the
      int8 conv MVAU with the residual add and the pool in its epilogue,
      run where the pool stands (every operand of the chain exists there);
    * each other ``add -> global_acc_pool`` pair
      (:func:`repro_torch.kernels.ops.residual_gaps`): one GAP call on both
      operands of the add.

    ``fold_pools=False`` folds only the ``im2col`` nodes, so each ``add``
    and ``global_acc_pool`` runs as a step of its own: the lowering the
    GAP folds are measured against.  The folded intermediates are listed, in node order, in the function's
    ``folded`` attribute.  The graph itself is not changed (the
    interpreter, :func:`repro_torch.core.graph.execute`, keeps every node).
    """
    import functools

    from repro_torch.kernels import ops as kops

    dev = resolve_device(device)
    impls = dict(_EXECUTORS)
    impls.update(kops.graph_op_impls())
    missing = sorted({n.op for n in graph.nodes if n.op not in impls})
    if missing:
        raise GraphBuildError(f"cannot lower graph '{graph.name}': no "
                              f"implementation for ops {missing}")
    consts = {k: as_tensor(v, dev) for k, v in graph.initializers.items()}
    nodes = [n.copy() for n in graph.nodes]       # freeze against later edits
    input_names = tuple(graph.inputs)
    output_names = tuple(graph.outputs)
    pairs = kops.conv_pairs(nodes, output_names)
    tails = kops.gap_tails(nodes, output_names) if fold_pools else {}
    residuals = (kops.residual_gaps(nodes, output_names, tails)
                 if fold_pools else {})
    convs = {n.outputs[0]: n for n in nodes if n.outputs[0] in pairs}
    folded = set(pairs)
    for mv, add in tails.values():
        folded |= {mv.outputs[0], add.outputs[0]}
    folded |= {add.outputs[0] for add in residuals.values()}
    steps = []                                    # (fn, input names, outputs)
    for node in nodes:
        out = node.outputs[0]
        if out in folded:
            continue                              # runs inside another step
        conv = (convs.get(node.inputs[0])
                if node.op in ("mvau", "mvau_int") else None)
        if out in tails:
            mv, add = tails[out]
            skip = next(i for i in add.inputs if i != mv.outputs[0])
            steps.append((functools.partial(kops.conv_mvau_int_gap_node,
                                            convs[mv.inputs[0]], mv, node),
                          (convs[mv.inputs[0]].inputs[0],)
                          + tuple(mv.inputs[1:]) + (skip,), node.outputs))
        elif out in residuals:
            steps.append((functools.partial(impls[node.op], node),
                          tuple(residuals[out].inputs), node.outputs))
        elif conv is not None:
            run = (kops.conv_mvau_int_node if node.op == "mvau_int"
                   else kops.conv_mvau_node)
            steps.append((functools.partial(run, conv, node),
                          (conv.inputs[0],) + tuple(node.inputs[1:]),
                          node.outputs))
        else:
            steps.append((functools.partial(impls[node.op], node),
                          tuple(node.inputs), node.outputs))

    def apply_fn(*inputs):
        if len(inputs) != len(input_names):
            raise TypeError(f"graph '{graph.name}' takes {len(input_names)} "
                            f"input(s) {input_names}, got {len(inputs)}")
        env: Dict[str, torch.Tensor] = dict(consts)
        env.update(zip(input_names, inputs))
        with torch.no_grad():
            for fn, ins, outs_names in steps:
                out = fn(*[env[i] for i in ins])
                outs = out if isinstance(out, (tuple, list)) else (out,)
                for name, val in zip(outs_names, outs):
                    env[name] = val
        return tuple(env[o] for o in output_names)

    apply_fn.folded = tuple(n.outputs[0] for n in nodes
                            if n.outputs[0] in folded)
    return apply_fn


def bucket_for(n: int, buckets: Sequence[int]) -> int:
    """Smallest bucket >= n."""
    if n <= 0:
        raise ValueError(f"batch size must be positive, got {n}")
    fit = [b for b in buckets if b >= n]
    if not fit:
        raise ValueError(f"batch {n} exceeds largest bucket "
                         f"{max(buckets)}; raise max_batch / split upstream")
    return min(fit)


def pow2_buckets(max_batch: int) -> Tuple[int, ...]:
    """(1, 2, 4, ..., max_batch) — max_batch is included even off-power."""
    bs = []
    b = 1
    while b < max_batch:
        bs.append(b)
        b *= 2
    bs.append(max_batch)
    return tuple(bs)


def normalize_buckets(buckets: Sequence[int]) -> Tuple[int, ...]:
    """Dedup + sort a bucket list; rejects empty lists and non-positive or
    non-integral sizes."""
    bs = set()
    for b in buckets:
        if int(b) != b or int(b) < 1:
            raise ValueError(f"buckets must be positive ints, got {buckets!r}")
        bs.add(int(b))
    if not bs:
        raise ValueError("buckets must be non-empty")
    return tuple(sorted(bs))


@dataclasses.dataclass
class DeployedModel:
    """A compiled, executable deployment artifact on one device.

    ``__call__`` runs the lowered graph (a single tensor when the graph has
    a single output).  ``warmup(buckets, example)`` makes each padded batch
    bucket a warmed shape (on the card: one CUDA graph each) and
    ``batched(x)`` pads any batch up to its bucket and slices the result
    back, so steady-state serving only replays (``trace_count`` stays flat
    after warmup).  A replay returns a copy of the graph's static outputs:
    the next replay never overwrites a caller's result, and callers on
    several threads are served one at a time (the artifact's lock).
    """

    graph: Graph
    recipe_name: str
    trace: PassTrace
    apply: Callable
    input_names: Tuple[str, ...]
    output_names: Tuple[str, ...]
    device: torch.device
    datapath: str = "f32"
    pass_names: Tuple[str, ...] = ()
    _buckets: Optional[Tuple[int, ...]] = None
    # the executable table: one CUDA graph per warmed input signature on the
    # card (the reference's AOT executables by (shape, dtype))
    _exec: GraphTable = dataclasses.field(init=False, repr=False)
    _fingerprint: Optional[str] = dataclasses.field(default=None, init=False,
                                                    repr=False)

    def __post_init__(self):
        self._exec = GraphTable(self.apply, self.device)

    def fingerprint(self) -> str:
        """Content digest of (graph structure + initializer bytes, datapath,
        build pass set), the reference's string for the same graph: two
        artifacts built differently never share a key."""
        if self._fingerprint is None:
            import hashlib

            from repro_torch.ckpt.compile_cache import graph_fingerprint

            pd = hashlib.sha256(
                "|".join(self.pass_names).encode()).hexdigest()[:8]
            self._fingerprint = (f"{graph_fingerprint(self.graph)}-"
                                 f"{self.datapath}-{pd}")
        return self._fingerprint

    @property
    def trace_count(self) -> int:
        """CUDA-graph captures plus the distinct input shapes run eagerly:
        flat after ``warmup`` == the serving loop only replays warmed
        buckets."""
        return self._exec.trace_count

    @property
    def compile_log(self) -> list:
        """Per warmed bucket: ``{"bucket", "seconds", "cached", "key"}``
        (seconds of warm-up runs and capture on the card, of the eager run
        on the CPU; never cached: the port has no compile cache yet)."""
        return self._exec.compile_log

    @property
    def buckets(self) -> Optional[Tuple[int, ...]]:
        return self._buckets

    def _inputs(self, args) -> Tuple[torch.Tensor, ...]:
        return tuple(as_tensor(a, self.device) for a in args)

    def _run(self, *xs: torch.Tensor):
        return self._exec(*xs)

    def warmup(self, buckets: Sequence[int],
               example: Union[torch.Tensor, np.ndarray], *,
               cache: Optional[Any] = None,
               metrics: Optional[Any] = None,
               label: Optional[str] = None) -> Tuple[int, ...]:
        """Warm one zero batch per bucket: on the card, capture it as a CUDA
        graph; on the CPU, run it once.  ``example`` is a BATCHED input of
        any batch size; its trailing dims/dtype define the sample shape.  A
        bucket already warmed is skipped.  Per-bucket seconds land in
        :attr:`compile_log` and, with ``metrics`` (a ``ServeMetrics``), in
        its compile counters under ``label`` (default: the graph's name).
        ``cache`` (the reference's persistent compile cache) is not ported
        and raises."""
        from repro_torch.models.layers import not_ported

        if cache is not None:
            raise not_ported("the persistent compile cache (warmup(cache=))",
                             "checkpoints and compile cache")
        if len(self.input_names) != 1:
            raise not_ported("warmup of a multi-input graph",
                             "compiled LM decode (lm-tiny)")
        ex = as_tensor(example, self.device)
        if ex.ndim < 1:
            raise ValueError("example must be batched (leading batch axis)")
        bs = normalize_buckets(buckets)
        for b in bs:
            x = torch.zeros((b,) + tuple(ex.shape[1:]), dtype=ex.dtype,
                            device=self.device)
            self._exec.warm((x,), name=label or self.graph.name,
                             metrics=metrics)
        self._buckets = bs
        return bs

    def batched(self, x: Union[torch.Tensor, np.ndarray]):
        """Run a batch padded up to the nearest warmed bucket and slice the
        result back (every op in the HW graph is per-sample independent)."""
        if self._buckets is None:
            raise RuntimeError("call warmup(buckets, example) before "
                               "batched()")
        x = as_tensor(x, self.device)
        n = x.shape[0]
        b = bucket_for(n, self._buckets)
        if b != n:
            pad = torch.zeros((b - n,) + tuple(x.shape[1:]), dtype=x.dtype,
                              device=x.device)
            x = torch.cat([x, pad])
        outs = tuple(o[:n] for o in self._run(x))
        return outs[0] if len(self.output_names) == 1 else outs

    def __call__(self, *inputs, **feeds):
        if feeds:
            try:
                args = tuple(feeds[n] for n in self.input_names)
            except KeyError as e:
                raise TypeError(f"missing graph input {e}; expected "
                                f"{self.input_names}") from None
            if inputs:
                raise TypeError("pass inputs positionally or by name, not both")
        else:
            args = inputs
        outs = self._run(*self._inputs(args))
        return outs[0] if len(self.output_names) == 1 else outs

    def op_counts(self) -> Dict[str, int]:
        from repro_torch.core.passes import op_histogram

        return op_histogram(self.graph)

    def dispatch_table(self) -> list:
        """Per-node kernel dispatch: ``[{"tensor", "op", "kernel"}]``, from
        :func:`repro_torch.kernels.ops.kernel_dispatch` — the same decision
        function the deployed executors run."""
        from repro_torch.kernels import ops as kops

        emulated = self.device.type != "cuda"
        folded = kops.folded_into(self.graph.nodes, self.graph.outputs)
        rows = []
        for n in self.graph.nodes:
            rows.append({"tensor": n.outputs[0], "op": n.op,
                         "kernel": kops.kernel_dispatch(
                             n, emulated, folded.get(n.outputs[0]))})
        return rows

    def profile(self, example, *, xla: bool = True,
                backend: Optional[str] = None) -> Dict[str, Any]:
        """Per-node FLOPs/bytes/estimated-ms attribution for one batch
        shape (:func:`repro_torch.obs.costmodel.profile_deployed`); the
        sweep records ``totals.est_ms`` as ``modeled_ms``.  The XLA
        cross-check (``xla=True``) has no counterpart here and raises."""
        from repro_torch.obs.costmodel import profile_deployed

        return profile_deployed(self, example, xla=xla, backend=backend)

    def qdq_counts(self) -> Dict[str, int]:
        """Surviving quantize/dequantize nodes and interior round-trip
        pairs (quantize fed directly by a dequantize)."""
        q = dq = pairs = 0
        for n in self.graph.nodes:
            if n.op == "quantize":
                q += 1
                p = self.graph.producer(n.inputs[0])
                if p is not None and p.op == "dequantize":
                    pairs += 1
            elif n.op == "dequantize":
                dq += 1
        return {"quantize": q, "dequantize": dq, "interior_pairs": pairs}

    def weight_bytes(self) -> int:
        """Storage bytes across all baked-in constants (weight codes,
        threshold tables); packed int4 counts at packed density."""
        return int(sum(np.asarray(v).nbytes
                       for v in self.graph.initializers.values()))

    def throughput(self, *inputs, iters: int = 20) -> Dict[str, float]:
        """Wall-clock of the artifact on BATCHED ``inputs``, synchronized
        with the device: ``{"ms_per_call", "calls_per_s", "batch"}``."""
        xs = self._inputs(inputs)
        n = int(xs[0].shape[0]) if xs and xs[0].ndim else 1

        def sync():
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)

        self._run(*xs)                                   # warm-up
        sync()
        t0 = time.perf_counter()
        for _ in range(max(iters, 1)):
            self._run(*xs)
        sync()
        dt = (time.perf_counter() - t0) / max(iters, 1)
        return {"ms_per_call": dt * 1e3, "calls_per_s": 1.0 / dt,
                "batch": float(n)}

    def report(self, sample_input=None, iters: int = 20) -> str:
        ops = ", ".join(f"{k}×{v}" for k, v in sorted(self.op_counts().items()))
        head = (f"DeployedModel('{self.graph.name}', recipe='{self.recipe_name}', "
                f"datapath='{self.datapath}', device='{self.device}', "
                f"{len(self.graph.nodes)} nodes: {ops})\n"
                f"  weight storage: {self.weight_bytes()} bytes")
        qdq = self.qdq_counts()
        head += (f"\n  quantize/dequantize surviving: {qdq['quantize']}/"
                 f"{qdq['dequantize']} (interior pairs: "
                 f"{qdq['interior_pairs']})")
        head += "\n  kernel dispatch:"
        for row in self.dispatch_table():
            head += (f"\n    {row['tensor']:28s} {row['op']:20s} "
                     f"-> {row['kernel']}")
        if sample_input is not None:
            t = self.throughput(sample_input, iters=iters)
            head += (f"\n  measured: {t['ms_per_call']:.2f} ms/call "
                     f"({t['calls_per_s']:.1f} calls/s) on {self.device}")
        return head + "\n" + self.trace.report()


def compile(graph_or_model: Any, qcfg: Any = None, *,
            recipe: Union[str, R.BuildRecipe],
            datapath: str = "f32",
            fuse: bool = True,
            sample_input: Optional[Any] = None,
            verify_feeds: Optional[Dict[str, Any]] = None,
            device: DeviceLike = None,
            rtol: float = 1e-5, atol: float = 1e-6) -> DeployedModel:
    """Build a :class:`DeployedModel` on ``device`` (default: the card).

    Args mirror the reference's ``repro.compile``:
      graph_or_model: a :class:`Graph`, or the recipe's native model object
        (a ResNet-9 param tree for ``recipe="resnet9"``).
      qcfg: the :class:`QuantConfig`, forwarded to the exporter.
      recipe: registered recipe name or a :class:`BuildRecipe`.
      datapath: ``"f32"`` runs the HW graph in float emulation of the
        fixed-point grid; ``"int"`` appends ``infer_datatypes`` +
        ``lower_to_integer_datapath`` (+ ``fuse_integer_datapath`` with
        ``fuse``): integer weight codes and ``mvau_int`` nodes, bit-for-bit
        equal to ``"f32"`` on the grid.
      sample_input / verify_feeds: golden input(s) for per-pass IO
        verification, executed on ``device``.
      device: where the artifact runs; ``"cpu"`` takes the plain versions.
    """
    if datapath not in ("f32", "int"):
        raise ValueError(f"datapath must be 'f32' or 'int', got {datapath!r}")
    dev = resolve_device(device)
    rec = R.recipe(recipe) if isinstance(recipe, str) else recipe
    if isinstance(graph_or_model, Graph):
        graph = graph_or_model
    elif rec.exporter is not None:
        graph = rec.exporter(graph_or_model, qcfg)
    else:
        raise TypeError(
            f"recipe '{rec.name}' has no exporter; pass a Graph (got "
            f"{type(graph_or_model).__name__})")
    if sample_input is not None and verify_feeds is None:
        if len(graph.inputs) != 1:
            raise ValueError("sample_input needs a single-input graph; use "
                             "verify_feeds for multi-input graphs")
        verify_feeds = {graph.inputs[0]: sample_input}

    passes = list(rec.passes)
    if datapath == "int":
        passes += ["infer_datatypes", "lower_to_integer_datapath"]
        if fuse:
            passes.append("fuse_integer_datapath")
    result = PassManager(rtol=rtol, atol=atol, device=dev).run(
        graph, passes, verify_feeds=verify_feeds)
    hw = result.graph
    from repro_torch.core.passes import resolve_pass

    return DeployedModel(
        graph=hw, recipe_name=rec.name, trace=result.trace,
        apply=lower_graph(hw, dev),
        input_names=tuple(hw.inputs), output_names=tuple(hw.outputs),
        device=dev, datapath=datapath,
        pass_names=tuple(resolve_pass(p).name for p in passes))
