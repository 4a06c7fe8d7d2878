"""One CUDA graph per warmed input shape: capture, replay, and the eager path.

The reference runs each warmed batch bucket as one compiled XLA executable
(``jit(...).lower(x).compile()``), so a call after warmup dispatches one
program.  On the card the port's counterpart is a CUDA graph: the lowered
function's launches (the MVAU / GAP / qmatmul kernels and the PyTorch ops
between them) are captured once over static input buffers and replayed as
one ``cudaGraphLaunch``.

* :class:`CapturedGraph` captures one function over fixed input tensors.
  It first runs the function eagerly on the capture's side stream (three
  times), so every lazy first-call step happens outside the capture: the
  kernel library's load, ``cudaFuncSetAttribute`` for large dynamic shared
  memory, the SM count the split planners read, cuBLAS's workspace for that
  stream.  Those runs also size the graph's own split-K tile counters
  (``kernels.build.GraphState``); the capture then records the launches
  each replay adds to ``kernels.build.launch_counts``.  The capture runs in
  ``thread_local`` error mode: another thread may replay or launch while it
  captures (a hot swap warms a new artifact while the engine serves).
* :class:`GraphTable` is one artifact's executable table: a graph per
  warmed input signature on the card, each replayed under the artifact's
  lock on the artifact's own stream (copy into the static input, replay,
  clone the static outputs, so a caller's result is never overwritten by
  the next replay).  Off the card, and for shapes that were not warmed, it
  runs the function eagerly.  ``trace_count`` counts captures plus the
  distinct shapes run eagerly: the reference's retrace counter, flat after
  warmup.

A capture that fails raises: nothing here falls back to the eager path on
the card.
"""

from __future__ import annotations

import gc
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.kernels import build as B

__all__ = ["CapturedGraph", "GraphTable"]

WARM_RUNS = 3


def _tuple(out) -> Tuple[torch.Tensor, ...]:
    return tuple(out) if isinstance(out, (tuple, list)) else (out,)


class CapturedGraph:
    """``fn(*inputs)`` captured as one CUDA graph over the tensors
    ``inputs``, which become the graph's static inputs (write new values
    into them, then :meth:`replay`); :attr:`outputs` are the static outputs
    the capture returned.

    ``pool`` is the memory pool the capture allocates from (graphs of one
    artifact share one, and are replayed one at a time); ``stream`` is the
    side stream the warm-up runs and the capture use.  :attr:`launches` is
    the record of kernel launches captured, :attr:`replays` the count of
    replays and :attr:`pool_bytes` the bytes the caching allocator reserved
    for the capture."""

    def __init__(self, fn: Callable, inputs: Sequence[torch.Tensor], *,
                 pool: Any, stream: torch.cuda.Stream):
        self.fn = fn           # keeps alive the tensors the graph reads
        self.inputs = tuple(inputs)
        dev = self.inputs[0].device
        state = B.GraphState()
        stream.wait_stream(torch.cuda.current_stream(dev))
        with torch.no_grad(), torch.cuda.stream(stream):
            with state.warming():
                for _ in range(WARM_RUNS):
                    fn(*self.inputs)
            stream.synchronize()
            reserved = torch.cuda.memory_reserved(dev)
            self.graph = torch.cuda.CUDAGraph()
            # no garbage collection inside the capture: a collection there
            # may free a dropped graph, whose memory pool goes back to the
            # device with a call that invalidates the capture
            collecting = gc.isenabled()
            gc.disable()
            try:
                with state.capture():
                    self.graph.capture_begin(
                        pool=pool, capture_error_mode="thread_local")
                    try:
                        out = fn(*self.inputs)
                    finally:
                        self.graph.capture_end()
            finally:
                if collecting:
                    gc.enable()
        self.outputs = _tuple(out)
        self.counters = state.counters       # kept alive with the graph
        self.launches: Dict[str, int] = dict(state.launches)
        self.pool_bytes = torch.cuda.memory_reserved(dev) - reserved
        self.replays = 0

    def replay(self) -> None:
        """One replay on the current stream; adds the captured launches to
        ``kernels.build.launch_counts``."""
        self.graph.replay()
        self.replays += 1
        B.add_launches(self.launches)


class GraphTable:
    """The executable table of one artifact: ``fn`` (``(*tensors) ->
    tensor or tuple``) with one :class:`CapturedGraph` per warmed input
    signature on the card.  Calls return a tuple of tensors."""

    def __init__(self, fn: Callable, device: torch.device):
        self.fn = fn
        self.device = device
        self.graphs: Dict[Tuple, CapturedGraph] = {}
        # per warmed shape: {"bucket", "seconds", "cached", "key"}, as the
        # reference's DeployedModel.compile_log
        self.compile_log: List[Dict[str, Any]] = []
        self._eager_shapes = set()
        self._lock = threading.Lock()
        self._stream: Optional[torch.cuda.Stream] = None
        self._pool = None

    @staticmethod
    def key(xs: Sequence[torch.Tensor]) -> Tuple:
        return tuple((tuple(x.shape), x.dtype) for x in xs)

    @property
    def trace_count(self) -> int:
        """Captures plus distinct input shapes run eagerly."""
        return len(self.graphs) + len(self._eager_shapes)

    def __call__(self, *xs: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        key = self.key(xs)
        g = self.graphs.get(key)
        if g is None:
            self._eager_shapes.add(key)
            with torch.no_grad():
                return _tuple(self.fn(*xs))
        cur = torch.cuda.current_stream(self.device)
        with self._lock:
            self._stream.wait_stream(cur)
            with torch.cuda.stream(self._stream):
                for s, x in zip(g.inputs, xs):
                    s.copy_(x)
                g.replay()
                outs = tuple(o.clone() for o in g.outputs)
            cur.wait_stream(self._stream)
        for o in outs:
            o.record_stream(cur)
        return outs

    def warm(self, xs: Sequence[torch.Tensor], *, name: str,
             metrics: Optional[Any] = None, cache: Optional[Any] = None,
             key: Optional[str] = None) -> None:
        """Make ``xs``'s signature a warmed shape: on the card, capture a
        graph with ``xs`` as its static inputs and replay it once; elsewhere,
        run it once eagerly.  A shape already warmed is skipped.

        With ``cache`` (a :class:`~repro_torch.ckpt.CompileCache`) and its
        ``key``, a miss publishes the bucket's warm record (bucket,
        signature, warm seconds, SHA-256 of that first replay's outputs, of
        the eager run on the CPU); a hit warms and captures the same way,
        then checks the first replay's digest against the record and raises
        :class:`~repro_torch.ckpt.compile_cache.WarmDigestMismatch` if they
        differ.  The seconds it took land in :attr:`compile_log` (with
        ``cached`` and ``key``) and, with ``metrics`` (a ``ServeMetrics``),
        in ``metrics.record_compile``."""
        from repro_torch.ckpt.compile_cache import (WarmDigestMismatch,
                                                    output_digest)

        sig = self.key(xs)
        bucket = int(xs[0].shape[0])
        t0 = time.perf_counter()
        with self._lock:
            if sig in self.graphs or (self.device.type != "cuda"
                                      and sig in self._eager_shapes):
                return
            built = {}

            def run(digest: bool = True) -> Optional[str]:
                """Capture (or run eagerly); with ``digest``, replay once
                and return the digest of the first outputs."""
                if self.device.type != "cuda":
                    self._eager_shapes.add(sig)
                    with torch.no_grad():
                        outs = _tuple(self.fn(*xs))
                    return output_digest(outs) if digest else None
                if self._stream is None:
                    self._stream = torch.cuda.Stream(self.device)
                    self._pool = torch.cuda.graph_pool_handle()
                g = built["graph"] = CapturedGraph(
                    self.fn, xs, pool=self._pool, stream=self._stream)
                if not digest:
                    return None
                with torch.cuda.stream(self._stream):
                    g.replay()
                    return output_digest(g.outputs)

            def record() -> Dict[str, Any]:
                digest = run()
                return {"bucket": bucket, "name": name,
                        "signature": [[list(s), str(d)] for s, d in sig],
                        "warm_s": time.perf_counter() - t0,
                        "sha256": np.frombuffer(bytes.fromhex(digest),
                                                np.uint8)}

            hit = False
            if cache is None:
                run(digest=False)
            else:
                rec, hit, _ = cache.get_or_compile(
                    key, record, meta={"artifact": name, "bucket": bucket})
                if hit:
                    digest = run()
                    want = bytes(np.asarray(rec["sha256"], np.uint8)).hex()
                    if digest != want:
                        self._eager_shapes.discard(sig)
                        raise WarmDigestMismatch(
                            f"{name} bucket {bucket}: the first replay's "
                            f"outputs digest to {digest[:16]}..., the cache "
                            f"entry {key} recorded {want[:16]}...: this "
                            "replica computes differently from the one that "
                            "published it")
            if "graph" in built:
                self.graphs[sig] = built["graph"]
        dt = time.perf_counter() - t0
        self.compile_log.append({"bucket": bucket, "seconds": dt,
                                 "cached": hit,
                                 "key": key if cache is not None else None})
        if metrics is not None:
            metrics.record_compile(name, bucket, dt, cached=hit)
