"""ServeCluster — replicated engines over one tenant registry, warmed
through a persistent compile cache.

Counterpart of the JAX package's ``serve/cluster/cluster.py``.  The
cluster composes the three layers of this subsystem into one front door:

* **Tenancy** — a :class:`TenantRegistry` resolves ``(tenant, artifact?)``
  to namespaced artifact names; per-tenant quotas inside each engine keep
  one flooding tenant from starving the rest (``TenantOverQuota``, not
  generic overload).
* **Replication** — N :class:`ServeEngine` replicas share the registry
  (same compiled backbones, same per-tenant stores), so any replica can
  serve any tenant and a register through one replica is visible to
  classifies through another.  Each tenant gets a HOME replica (assigned
  round-robin at ``add_tenant``) and its traffic goes there first: tenants
  are spread across replicas, so one tenant's admitted load queues behind
  its own work, not its neighbours'.  A full replica fails over to the
  next one (capacity is routable); a quota rejection does NOT — the quota
  is per-tenant policy, and spilling an over-quota tenant onto other
  replicas would hand it exactly the blast radius quotas exist to remove.
* **Cold start** — :meth:`warmup` runs every artifact × bucket through a
  :class:`repro_torch.ckpt.CompileCache`: the first replica ever to warm
  captures each bucket's CUDA graph and publishes its warm record (the
  digest of the first replay); a restarted process captures again and
  checks its first replay against the record, so a replica that computes
  differently fails loudly.  Replicas in one process share the artifacts,
  so :meth:`add_replica` finds every bucket warm and captures nothing.

One registry + one store per (tenant, backbone) means cross-replica
consistency is the store's own thread-safe bit-for-bit fold — the cluster
adds routing, not state.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Dict, Hashable, List, Optional, Sequence

from repro_torch.device import DeviceLike
from repro_torch.obs import get_tracer
from repro_torch.serve.cluster.sharded import ShardedNCMHead, ShardedStore
from repro_torch.serve.cluster.tenancy import TenantRegistry
from repro_torch.serve.engine import (ServeEngine, ServeOverload,
                                     TenantOverQuota)

__all__ = ["ServeCluster"]


class ServeCluster:
    """Multi-replica, multi-tenant front door over a :class:`TenantRegistry`.

    ::

        reg = TenantRegistry()
        reg.register_backbone("w6a4-int", feats, default=True)
        cluster = ServeCluster(reg, replicas=2, tenant_quota=0.25,
                               compile_cache=CompileCache(cache_dir))
        cluster.add_tenant("acme")
        cluster.warmup(img=32)
        cluster.submit_register("acme", "pelican", shots).result()
        cluster.submit_classify("acme", frame).result()
    """

    def __init__(self, registry: TenantRegistry, *, replicas: int = 1,
                 max_batch: int = 64, max_queue: int = 256,
                 batch_wait_ms: float = 2.0,
                 tenant_quota: Optional[float] = None,
                 buckets: Optional[Sequence[int]] = None,
                 compile_cache: Optional[Any] = None,
                 tracer: Optional[Any] = None,
                 start: bool = True):
        if replicas < 1:
            raise ValueError(f"need at least one replica, got {replicas}")
        self.registry = registry
        self.compile_cache = compile_cache
        # One tracer for the whole cluster: the trace ID is minted HERE and
        # handed into whichever replica admits the request, so routing
        # (home replica, failovers) and the engine lifecycle share a trace.
        self.tracer = tracer if tracer is not None else get_tracer()
        self._engine_kw = dict(max_batch=max_batch, max_queue=max_queue,
                               batch_wait_ms=batch_wait_ms,
                               tenant_quota=tenant_quota, buckets=buckets,
                               tracer=self.tracer)
        self._lock = threading.Lock()
        self._rr = 0
        self._home: Dict[Hashable, int] = {}
        self._warm_img: Optional[int] = None
        self.engines: List[ServeEngine] = [
            ServeEngine(registry, start=start, **self._engine_kw)
            for _ in range(replicas)]

    # -- tenancy passthrough ------------------------------------------------
    def add_tenant(self, tenant: str, **kw) -> str:
        """Register the tenant's namespace and pin its home replica —
        assigned round-robin over the current replicas, so tenants spread
        out and one tenant's queue wait is behind its own admitted work,
        not a co-tenant's."""
        name = self.registry.add_tenant(tenant, **kw)
        with self._lock:
            if tenant not in self._home:
                self._home[tenant] = len(self._home) % len(self.engines)
        return name

    def home_replica(self, tenant: Hashable) -> int:
        """Index into :attr:`engines` of the tenant's home replica."""
        with self._lock:
            return self._home[tenant]

    # -- lifecycle ----------------------------------------------------------
    def warmup(self, img: int = 32) -> Dict[str, Optional[int]]:
        """Warm every replica.  The first engine's sweep captures each
        distinct backbone's graphs exactly once (checked against the cache's
        warm records on a restart); the artifacts are shared, so the
        remaining replicas' sweeps find every bucket already warm and cost
        microseconds."""
        counts: Dict[str, Optional[int]] = {}
        for eng in list(self.engines):
            counts = eng.warmup(img=img, cache=self.compile_cache)
        self._warm_img = img
        return counts

    def add_replica(self, warm: bool = True) -> ServeEngine:
        """Scale out (or stand in for a restarted replica): a new engine
        over the same registry.  The artifacts are shared, so its warmup
        finds every bucket warm and captures nothing."""
        eng = ServeEngine(self.registry, start=True, **self._engine_kw)
        if warm and self._warm_img is not None:
            eng.warmup(img=self._warm_img, cache=self.compile_cache)
        with self._lock:
            self.engines.append(eng)
        return eng

    def stop(self, drain: bool = True) -> None:
        for eng in list(self.engines):
            eng.stop(drain=drain)

    def __enter__(self) -> "ServeCluster":
        for eng in self.engines:
            eng.start()
        return self

    def __exit__(self, *exc) -> None:
        self.stop(drain=not any(exc))

    # -- routing ------------------------------------------------------------
    def _pick(self, tenant: Hashable = None) -> List[ServeEngine]:
        """Replicas in failover order.  A tenant with a home replica starts
        there (so its queue wait is behind its own admitted work, not a
        co-tenant's); anything else starts at the round-robin cursor."""
        with self._lock:
            engines = list(self.engines)
            start = self._home.get(tenant)
            if start is None:
                self._rr = (self._rr + 1) % len(engines)
                start = self._rr
            start %= len(engines)
            return engines[start:] + engines[:start]

    def _submit(self, kind: str, tenant: Hashable, x, class_id,
                artifact: Optional[str], timeout: Optional[float]):
        tr = self.tracer
        t0 = time.perf_counter()
        trace = tr.new_trace()           # ONE trace ID across route + serve
        name = self.registry.resolve(tenant, artifact)
        engines = self._pick(tenant)
        last: Optional[Exception] = None
        failovers = 0

        def route_span(replica: int, status: str) -> None:
            if tr.enabled:
                tr.record("cluster.route", t0, time.perf_counter(),
                          trace=trace,
                          parent=ServeEngine._root_span(trace),
                          status=status,
                          attrs={"tenant": tenant, "artifact": name,
                                 "replica": replica,
                                 "failovers": failovers})

        for i, eng in enumerate(engines):
            try:
                if kind == "register":
                    fut = eng.submit_register(class_id, x, artifact=name,
                                              timeout=timeout, tenant=tenant,
                                              trace=trace)
                else:
                    fut = eng.submit_classify(x, artifact=name,
                                              timeout=timeout, tenant=tenant,
                                              trace=trace)
                route_span(i, "ok")
                return fut
            except TenantOverQuota:
                # quota is per-tenant POLICY, not replica capacity — spilling
                # an over-quota tenant onto its neighbours' home replicas
                # would hand it exactly the blast radius quotas exist to
                # remove.  The home replica's rejection is authoritative.
                route_span(i, "rejected:over_quota")
                raise
            except ServeOverload as e:
                last = e  # replica CAPACITY is routable: try the next one
                failovers += 1
        route_span(len(engines) - 1, "rejected:overload")
        raise last if last is not None else ServeOverload("no replicas")

    def submit_register(self, tenant: Hashable, class_id: Hashable, x,
                        artifact: Optional[str] = None,
                        timeout: Optional[float] = None):
        """Register support shots for ``tenant``'s ``class_id`` (its private
        store) through its home replica, failing over on overload."""
        return self._submit("register", tenant, x, class_id, artifact, timeout)

    def submit_classify(self, tenant: Hashable, x,
                        artifact: Optional[str] = None,
                        timeout: Optional[float] = None):
        """Classify queries against ``tenant``'s prototypes."""
        return self._submit("classify", tenant, x, None, artifact, timeout)

    # -- observability ------------------------------------------------------
    def trace_counts(self) -> Dict[str, Optional[int]]:
        return self.registry.trace_counts()

    def metrics_snapshot(self) -> Dict[str, Any]:
        """Aggregated per-replica, per-tenant, and cold-start numbers."""
        replicas = [eng.metrics.snapshot() for eng in list(self.engines)]
        tenants: Dict[Any, Dict[str, float]] = {}
        for eng in list(self.engines):
            for tenant, snap in eng.metrics.tenant_snapshot().items():
                agg = tenants.setdefault(tenant, dict.fromkeys(
                    ("completed", "rejected", "over_quota", "failed"), 0.0))
                for key in ("completed", "rejected", "over_quota", "failed"):
                    agg[key] += snap[key]
        compile_s = sum(eng.metrics.compile_snapshot()["compile_s"]
                        for eng in list(self.engines))
        return {"replicas": replicas, "tenants": tenants,
                "compile_s": compile_s,
                "completed": sum(r["completed"] for r in replicas),
                "rejected": sum(r["rejected"] for r in replicas),
                "over_quota": sum(r["over_quota"] for r in replicas)}


def sharded_tenant_registry(devices: Optional[List] = None,
                            device: DeviceLike = None) -> TenantRegistry:
    """A :class:`TenantRegistry` whose per-tenant stores classify through
    one shared :class:`ShardedNCMHead` — on one device the exact serial
    head; over more, its prototype rows split across the ranks of the
    caller's process group (every rank classifies alike).  ``device`` places the
    stores as :class:`TenantRegistry` does (default: each backbone's own
    device)."""
    head = ShardedNCMHead(devices)
    return TenantRegistry(store_factory=lambda dev: ShardedStore(head, dev),
                          device=device)
