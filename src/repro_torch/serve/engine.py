"""ServeEngine — real-time few-shot serving with dynamic batching.

The port's copy of the JAX package's ``serve/engine.py``: the paper's
deployment loop (support shots and queries arriving live at the card) under
production traffic discipline:

* **Admission**: a bounded FIFO queue.  When it is full, ``submit_*``
  raises :class:`ServeOverload` (or blocks up to ``timeout``) — load sheds
  at the door instead of growing an unbounded backlog.  Per-tenant quotas
  raise :class:`TenantOverQuota` for one tenant while others are admitted.
* **Coalescing**: a worker thread drains the queue, packing requests —
  register and classify alike, they all need backbone features — into one
  batch of up to ``max_batch`` samples, waiting at most ``batch_wait_ms``
  for stragglers.  Batches are padded to power-of-two buckets, and after
  :meth:`warmup` every bucket is a captured CUDA graph on the card, so a
  batch is one replay and **nothing is captured or run eagerly under load**
  (``trace_counts`` proves it).
* **Semantics**: requests take effect in strict arrival order — a classify
  sees exactly the registers admitted before it, whether or not they rode
  the same batch.  Combined with the store's canonical left-fold, a served
  prototype is bit-for-bit what an offline NCM over the same shots would
  compute.
* **A/B**: each request may name an artifact from the
  :class:`ArtifactRegistry` (e.g. ``w6a4-int`` vs ``f32``); unnamed
  requests follow the registry default, which hot-swaps atomically at
  batch granularity.  An artifact registered and warmed while the engine
  serves captures its graphs beside the worker's replays (captures run in
  ``thread_local`` mode, on the artifact's own stream).

Workload specifics (what a request kind means, how a group executes) live
in the artifact's :class:`~repro_torch.serve.workload.ArtifactAdapter`; the
engine itself is workload-agnostic.
"""

from __future__ import annotations

import dataclasses
import queue
import threading
import time
from concurrent.futures import Future
from typing import Any, Dict, Hashable, List, Optional, Sequence, Tuple

from repro_torch.core.deploy import normalize_buckets, pow2_buckets
from repro_torch.obs import get_tracer
from repro_torch.serve.metrics import ServeMetrics
from repro_torch.serve.registry import ArtifactRegistry
from repro_torch.serve.workload import ClassifyResult, default_adapter

__all__ = ["ClassifyResult", "ServeEngine", "ServeOverload",
           "TenantOverQuota"]


class ServeOverload(RuntimeError):
    """Admission queue full — shed load or retry with backoff."""


class TenantOverQuota(ServeOverload):
    """THIS tenant's queue share is exhausted — other tenants are still
    admitted.  A distinct type (not bare :class:`ServeOverload`) so a
    client can tell "I am being throttled" from "the engine is drowning"."""


@dataclasses.dataclass
class _Request:
    kind: str                       # a RequestKind name on the adapter
    payload: Any                    # kind-specific, validated at submit
    artifact: Optional[str]
    future: Future
    t_submit: float
    n_rows: int = 1                 # batch-row footprint (coalescing unit)
    tenant: Optional[Hashable] = None
    # request-lifecycle tracing (repro_torch.obs): one trace ID per request plus
    # the perf_counter timestamps the worker turns into post-hoc spans —
    # admission (t_submit→t_enq), queue (t_enq→t_deq), coalesce
    # (t_deq→exec), exec, respond (t_exec1→fulfil)
    trace: str = ""
    t_enq: float = 0.0
    t_deq: float = 0.0
    t_exec1: float = 0.0

    @property
    def n(self) -> int:
        return self.n_rows


class ServeEngine:
    """Dynamic-batching server over an :class:`ArtifactRegistry`."""

    def __init__(self, registry: ArtifactRegistry, *,
                 max_batch: int = 64, max_queue: int = 256,
                 batch_wait_ms: float = 2.0,
                 buckets: Optional[Sequence[int]] = None,
                 metrics_window: int = 10_000,
                 tenant_quota: Optional[float] = None,
                 tracer: Optional[Any] = None,
                 start: bool = True):
        self.registry = registry
        # Request tracing (repro_torch.obs): defaults to the process-global
        # tracer, which is a no-op until obs.configure() attaches an
        # exporter — every hot-path site guards on tracer.enabled, so the
        # disabled cost is one attribute read per site plus the trace ID.
        self.tracer = tracer if tracer is not None else get_tracer()
        self.max_batch = int(max_batch)
        self.buckets = (normalize_buckets(buckets) if buckets
                        else pow2_buckets(self.max_batch))
        if self.buckets[-1] < self.max_batch:
            raise ValueError(f"largest bucket {self.buckets[-1]} < "
                             f"max_batch {self.max_batch}")
        self.batch_wait_s = batch_wait_ms / 1e3
        self.metrics = ServeMetrics(window=metrics_window)
        self._queue: "queue.Queue[_Request]" = queue.Queue(maxsize=max_queue)
        # Per-tenant admission quota: the max share of the queue one tenant
        # may occupy.  A float in (0, 1] is a fraction of max_queue, an int
        # >= 1 an absolute request count.  Tenanted submits beyond the share
        # raise TenantOverQuota while other tenants keep getting admitted —
        # one flooding tenant cannot starve the rest.  None (default) or
        # untenanted requests bypass quota accounting entirely.
        self.tenant_quota = self._normalize_quota(tenant_quota, max_queue)
        self._tenant_lock = threading.Lock()
        self._tenant_queued: Dict[Hashable, int] = {}
        self._pending: Optional[_Request] = None     # coalescer carry slot
        self._stop = threading.Event()
        self._worker: Optional[threading.Thread] = None
        if start:
            self.start()

    @staticmethod
    def _normalize_quota(quota, max_queue: int) -> Optional[int]:
        if quota is None:
            return None
        if isinstance(quota, float) and 0 < quota <= 1:
            n = int(max_queue * quota)          # fraction of the shared queue
        elif isinstance(quota, int) and quota >= 1:
            n = quota                           # absolute request count
        else:
            raise ValueError(f"tenant_quota must be a float fraction in "
                             f"(0, 1] or an int >= 1, got {quota!r}")
        return max(n, 1)

    # -- lifecycle ----------------------------------------------------------
    def start(self) -> None:
        if self._worker is not None and self._worker.is_alive():
            return
        self._stop.clear()
        self._worker = threading.Thread(target=self._run, name="serve-engine",
                                        daemon=True)
        self._worker.start()

    def stop(self, drain: bool = True) -> None:
        """Stop the worker; ``drain=True`` serves everything already
        admitted first, ``drain=False`` fails queued requests."""
        if not drain:
            self._fail_queued(ServeOverload("engine stopped"))
        self._stop.set()
        if self._worker is not None:
            self._worker.join(timeout=60.0)
            self._worker = None

    def __enter__(self) -> "ServeEngine":
        self.start()
        return self

    def __exit__(self, *exc) -> None:
        self.stop(drain=not any(exc))

    def warmup(self, img: int = 32, buckets: Optional[Sequence[int]] = None,
               cache: Optional[Any] = None) -> Dict[str, Optional[int]]:
        """Warm every registered artifact at every bucket shape (on the
        card: capture one CUDA graph per bucket), then reset the throughput
        clock.  Returns the post-warmup trace counts — the baseline a
        zero-retrace assertion diffs against.

        A ``buckets`` override REPLACES the engine's bucket set (padding
        must only ever target warmed shapes — warming a subset while
        padding to the old set would quietly reintroduce mid-flight
        retraces), so it still has to cover ``max_batch``.

        ``cache`` (a :class:`repro_torch.ckpt.CompileCache`) publishes each
        bucket's warm record or, on a restarted replica, captures again and
        checks the first replay against it; per-bucket warm times land in
        ``self.metrics`` either way, marked cached on a restore."""
        bs = self.buckets
        if buckets is not None:
            bs = normalize_buckets(buckets)
            if bs[-1] < self.max_batch:
                raise ValueError(f"largest warmup bucket {bs[-1]} < "
                                 f"max_batch {self.max_batch}")
        for name in self.registry.names():
            self.registry.get(name).warmup(bs, img=img, cache=cache,
                                           metrics=self.metrics)
        # publish only AFTER capturing: concurrent traffic keeps padding to
        # the old (fully warmed) set until every new shape has a graph
        self.buckets = bs
        self.metrics.reset_clock()
        return self.trace_counts()

    def trace_counts(self) -> Dict[str, Optional[int]]:
        return self.registry.trace_counts()

    # -- admission ----------------------------------------------------------
    def submit(self, kind: str, payload: Any, *,
               artifact: Optional[str] = None,
               timeout: Optional[float] = None,
               tenant: Optional[Hashable] = None,
               trace: Optional[str] = None) -> Future:
        """Queue one request of ``kind`` for the artifact's workload
        adapter.  The adapter's :class:`RequestKind` validates the payload
        here, in the caller's thread — malformed payloads and unknown
        kinds raise ``ValueError`` immediately rather than failing the
        future.  Admission (queue bounds, tenant quotas, tracing) is
        workload-agnostic and identical for every kind."""
        return self._submit(kind, payload, artifact, timeout, tenant, trace)

    def submit_register(self, class_id: Hashable, x,
                        artifact: Optional[str] = None,
                        timeout: Optional[float] = None,
                        tenant: Optional[Hashable] = None,
                        trace: Optional[str] = None) -> Future:
        """Queue support images (k, H, W, C) for online registration of
        ``class_id``.  Future resolves to the class's new shot count.
        Thin wrapper over ``submit("register", ...)``."""
        return self.submit("register", {"class_id": class_id, "x": x},
                           artifact=artifact, timeout=timeout, tenant=tenant,
                           trace=trace)

    def submit_classify(self, x, artifact: Optional[str] = None,
                        timeout: Optional[float] = None,
                        tenant: Optional[Hashable] = None,
                        trace: Optional[str] = None) -> Future:
        """Queue query images (n, H, W, C).  Future resolves to a
        :class:`ClassifyResult`.  Thin wrapper over
        ``submit("classify", ...)``."""
        return self.submit("classify", {"x": x}, artifact=artifact,
                           timeout=timeout, tenant=tenant, trace=trace)

    @staticmethod
    def _root_span(trace: str) -> str:
        """Deterministic root-span ID for a trace — children emitted from
        the worker thread can parent onto it before the root itself is
        exported at fulfil time."""
        return trace + "-00"

    def _resolve_adapter(self, artifact: Optional[str]):
        """The workload adapter behind an artifact name, or ``None`` when
        the name (or the empty-registry default) does not resolve — in
        which case validation is skipped and the request fails in the
        worker with the same ``KeyError`` it always did."""
        try:
            art = self.registry.get(artifact)
        except KeyError:
            return None
        return art.adapter if art.adapter is not None else default_adapter()

    def _submit(self, kind, payload, artifact, timeout,
                tenant=None, trace=None) -> Future:
        t_sub = time.perf_counter()
        adapter = self._resolve_adapter(artifact)
        n_rows = 1
        if adapter is not None:
            rk = adapter.kinds.get(kind)
            if rk is None:
                raise ValueError(
                    f"unknown request kind {kind!r}; artifact "
                    f"{(artifact or self.registry.default_name)!r} accepts "
                    f"{sorted(adapter.kinds)}")
            payload = rk.validate(payload, self)
            n_rows = int(rk.rows(payload))
            if n_rows > self.max_batch:
                raise ValueError(f"request of {n_rows} samples exceeds "
                                 f"max_batch={self.max_batch}; split it")
        tr = self.tracer
        # the ID is the ONE tracing allocation the disabled path keeps: it
        # rides error messages and propagation from an upstream caller
        trace = trace or tr.new_trace()
        if self._stop.is_set():
            # a stopped engine has no drain — admitting would hang the
            # future forever.  (Submitting BEFORE the first start() is
            # allowed: the queue holds until the worker comes up.)
            self.metrics.record_rejected(tenant)
            if tr.enabled:
                tr.record("serve.request", t_sub, time.perf_counter(),
                          trace=trace, span_id=self._root_span(trace),
                          status="rejected:stopped",
                          attrs={"tenant": tenant, "kind": kind})
            raise ServeOverload("engine is stopped; call start() first")
        try:
            self._admit_tenant(tenant)
        except TenantOverQuota:
            if tr.enabled:
                tr.record("serve.request", t_sub, time.perf_counter(),
                          trace=trace, span_id=self._root_span(trace),
                          status="rejected:over_quota",
                          attrs={"tenant": tenant, "kind": kind})
            raise
        req = _Request(kind, payload, artifact, Future(), t_sub,
                       n_rows=n_rows, tenant=tenant, trace=trace)
        req.future.trace_id = trace        # client-side trace handle
        req.t_enq = time.perf_counter()    # before put: the worker may
        try:                               # dequeue it immediately
            if timeout is None:
                self._queue.put_nowait(req)
            else:
                self._queue.put(req, timeout=timeout)
        except queue.Full:
            self._release_tenant(tenant)
            self.metrics.record_rejected(tenant)
            if tr.enabled:
                tr.record("serve.request", t_sub, time.perf_counter(),
                          trace=trace, span_id=self._root_span(trace),
                          status="rejected:queue_full",
                          attrs={"tenant": tenant, "kind": kind})
            raise ServeOverload(
                f"admission queue full ({self._queue.maxsize}); "
                f"{self.metrics.completed} served so far") from None
        if tr.enabled:
            tr.record("serve.admission", t_sub, req.t_enq, trace=trace,
                      parent=self._root_span(trace),
                      attrs={"tenant": tenant, "kind": kind, "n": req.n,
                             "artifact": artifact})
        self.metrics.observe_queue_depth(self._queue.qsize())
        return req.future

    # -- per-tenant quota accounting ----------------------------------------
    def _admit_tenant(self, tenant) -> None:
        """Reserve one unit of ``tenant``'s queue share, or raise
        :class:`TenantOverQuota` — BEFORE the shared queue is touched, so a
        quota-bound tenant can never convert its overflow into shared-queue
        pressure."""
        if tenant is None or self.tenant_quota is None:
            return
        with self._tenant_lock:
            n = self._tenant_queued.get(tenant, 0)
            if n >= self.tenant_quota:
                self.metrics.record_rejected(tenant, over_quota=True)
                raise TenantOverQuota(
                    f"tenant {tenant!r} has {n} queued requests "
                    f"(quota {self.tenant_quota}); shed load or back off")
            self._tenant_queued[tenant] = n + 1

    def _release_tenant(self, tenant) -> None:
        if tenant is None or self.tenant_quota is None:
            return
        with self._tenant_lock:
            n = self._tenant_queued.get(tenant, 0)
            if n > 1:
                self._tenant_queued[tenant] = n - 1
            else:
                self._tenant_queued.pop(tenant, None)

    def tenant_queue_depths(self) -> Dict[Hashable, int]:
        with self._tenant_lock:
            return dict(self._tenant_queued)

    # -- worker -------------------------------------------------------------
    def _fulfill(self, req: _Request, value) -> None:
        """Resolve a request's future, tolerating client-side ``cancel()``:
        a Future cancelled while queued refuses set_result with
        InvalidStateError, which must never kill the worker thread.  (State
        changes are best-effort against cancellation: a register whose
        future was cancelled mid-batch has still updated the store.)"""
        if req.future.set_running_or_notify_cancel():
            req.future.set_result(value)
            t_now = time.perf_counter()
            self.metrics.record_request(t_now - req.t_submit,
                                        tenant=req.tenant)
            self._close_trace(req, t_now, "ok")
        else:
            self.metrics.record_cancelled()
            self._close_trace(req, time.perf_counter(), "cancelled")

    def _fail(self, req: _Request, exc: Exception) -> None:
        if req.future.set_running_or_notify_cancel():
            req.future.set_exception(exc)
            self.metrics.record_request(0.0, ok=False, tenant=req.tenant)
            self._close_trace(req, time.perf_counter(),
                              f"error:{type(exc).__name__}")
        else:
            self.metrics.record_cancelled()
            self._close_trace(req, time.perf_counter(), "cancelled")

    def _close_trace(self, req: _Request, t_now: float, status: str) -> None:
        """Emit the respond child and the request root span (the root's ID
        is deterministic, so the earlier admission/queue/exec children
        already parent onto it)."""
        tr = self.tracer
        if not (tr.enabled and req.trace):
            return
        root = req.trace + "-00"
        evs = []
        if req.t_exec1:
            evs.append(("serve.respond", req.t_exec1, t_now, req.trace,
                        root, None, None, None))
        evs.append(("serve.request", req.t_submit, t_now, req.trace,
                    None, root, status,
                    {"tenant": req.tenant, "kind": req.kind,
                     "n": req.n, "artifact": req.artifact}))
        tr.record_many(evs)

    def _run(self) -> None:
        while True:
            batch = self._next_batch()
            if batch is None:
                return
            try:
                self._process(batch)
            except Exception as e:                    # noqa: BLE001
                # _process fails futures per group; this is the backstop
                # that keeps the worker alive no matter what — a dead
                # worker turns every future submit into a hang
                for r in batch:
                    if not r.future.done():
                        self._fail(r, e)

    def _next_batch(self) -> Optional[List[_Request]]:
        first = self._pending
        self._pending = None
        while first is None:
            try:
                first = self._queue.get(timeout=0.05)
                first.t_deq = time.perf_counter()
                self._release_tenant(first.tenant)
            except queue.Empty:
                if self._stop.is_set():
                    return None
                continue
        batch, total = [first], first.n
        deadline = time.perf_counter() + self.batch_wait_s
        while total < self.max_batch:
            rem = deadline - time.perf_counter()
            try:
                nxt = self._queue.get_nowait() if rem <= 0 else \
                    self._queue.get(timeout=rem)
                nxt.t_deq = time.perf_counter()
                self._release_tenant(nxt.tenant)
            except queue.Empty:
                break
            if total + nxt.n > self.max_batch:
                self._pending = nxt         # strict FIFO: head of next batch
                break
            batch.append(nxt)
            total += nxt.n
        return batch

    def _process(self, batch: List[_Request]) -> None:
        # Resolve each request's artifact (default resolved once per batch,
        # so a hot-swap lands between batches and "artifact=None" requests
        # join the default's group), then group by the artifact's workload
        # adapter plus the adapter's own ``group_key`` — for the default
        # FSL adapter that key is the FEATS OBJECT, not the artifact name:
        # views of one backbone share its graphs, and the point of
        # coalescing is ONE padded backbone replay for all of them — the
        # per-view part (the store) is routed per request afterwards.
        # Arrival order inside each group survives.
        default = None
        groups: Dict[Tuple[int, Hashable],
                     Tuple[Any, List[Tuple[Any, _Request]]]] = {}
        for r in batch:
            try:
                if r.artifact is None:
                    if default is None:
                        default = self.registry.get(None)
                    art = default
                else:
                    art = self.registry.get(r.artifact)
            except KeyError as e:
                self._fail(r, e)
                continue
            adapter = (art.adapter if art.adapter is not None
                       else default_adapter())
            key = (id(adapter), adapter.group_key(art))
            groups.setdefault(key, (adapter, []))[1].append((art, r))
        for adapter, pairs in groups.values():
            self._run_group(adapter, pairs)

    def _run_group(self, adapter: Any,
                   pairs: List[Tuple[Any, _Request]]) -> None:
        # Kinds were validated at submit against the THEN-resolved adapter;
        # a default hot-swap between submit and dispatch can hand a request
        # to an adapter that never heard of its kind.  Fail those futures
        # here (never the worker) and serve the rest.
        good: List[Tuple[Any, _Request]] = []
        for art, r in pairs:
            if r.kind not in adapter.kinds:
                self._fail(r, ValueError(
                    f"artifact {art.name!r} does not accept request kind "
                    f"{r.kind!r}; have {sorted(adapter.kinds)}"))
                continue
            good.append((art, r))
        if good:
            adapter.run_group(self, good)

    def _fail_queued(self, exc: Exception) -> None:
        while True:
            try:
                r = self._queue.get_nowait()
            except queue.Empty:
                return
            self._release_tenant(r.tenant)
            self._fail(r, exc)
