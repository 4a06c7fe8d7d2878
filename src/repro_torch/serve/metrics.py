"""Serving metrics — per-request latency percentiles and steady-state
throughput, the numbers the paper's Table III becomes under load.

The port's copy of the JAX package's ``serve/metrics.py``, on the port's
:class:`repro_torch.obs.metrics.MetricsRegistry`: every counter, gauge and
histogram lives in one registry behind ONE shared re-entrant lock, and the
latency reservoirs take the same lock — so a :meth:`snapshot` is a
consistent cut, and :meth:`prometheus` renders the whole registry in text
exposition format for scraping.

The latency *percentiles* come from bounded exact reservoirs (deques), not
histogram buckets — a soak can push millions of requests without the
object growing, and p99 stays exact over the window.  The histogram feeds
the Prometheus view only.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Dict

from repro_torch.obs.metrics import MetricsRegistry

__all__ = ["ServeMetrics", "percentile"]

# latency histogram bounds in ms (Prometheus exposition only; percentiles
# are exact from the reservoir)
_LAT_BUCKETS_MS = (0.5, 1, 2.5, 5, 10, 25, 50, 100, 250, 500, 1000, 5000)


def percentile(sorted_vals, p: float) -> float:
    """Nearest-rank percentile on an already-sorted sequence (p in [0,100])."""
    if not sorted_vals:
        return float("nan")
    k = max(0, min(len(sorted_vals) - 1,
                   int(round(p / 100.0 * (len(sorted_vals) - 1)))))
    return float(sorted_vals[k])


class ServeMetrics:
    """Counters + bounded latency reservoir for one :class:`ServeEngine`.

    All state sits behind ``self._lock`` — an RLock shared with the
    embedded :class:`MetricsRegistry`, so registry updates nested inside a
    locked section never deadlock and every read path (``snapshot``,
    ``tenant_snapshot``, the public counter properties) sees one consistent
    world.
    """

    def __init__(self, window: int = 10_000):
        self._lock = threading.RLock()
        self._window = window
        self._lat = deque(maxlen=window)       # seconds, completed requests
        self._t0 = time.perf_counter()
        self.registry = MetricsRegistry(lock=self._lock)
        reg = self.registry
        self._c_completed = reg.counter(
            "repro_serve_completed_total", "requests served OK")
        self._c_failed = reg.counter(
            "repro_serve_failed_total", "requests failed with an exception")
        self._c_cancelled = reg.counter(
            "repro_serve_cancelled_total", "futures cancelled while queued")
        self._c_rejected = reg.counter(
            "repro_serve_rejected_total", "admission rejections")
        self._c_over_quota = reg.counter(
            "repro_serve_over_quota_total", "per-tenant quota rejections")
        self._c_batches = reg.counter(
            "repro_serve_batches_total", "coalesced backbone batches")
        self._c_real = reg.counter(
            "repro_serve_batched_samples_total",
            "real samples through the backbone")
        self._c_padded = reg.counter(
            "repro_serve_padded_samples_total",
            "wasted rows from bucket padding")
        self._g_depth = reg.gauge(
            "repro_serve_queue_depth_max", "admission queue high-water mark")
        self._h_lat = reg.histogram(
            "repro_serve_latency_ms", "request latency, submit to fulfil",
            buckets=_LAT_BUCKETS_MS)
        self._c_compile = reg.counter(
            "repro_serve_compile_total", "warmup executable builds",
            labelnames=("cached",))
        self._c_compile_s = reg.counter(
            "repro_serve_compile_seconds_total", "warmup wall-clock",
            labelnames=("cached",))
        self._c_tenant = reg.counter(
            "repro_serve_tenant_requests_total", "per-tenant outcomes",
            labelnames=("tenant", "status"))
        # per-tenant exact latency reservoirs (noisy-neighbor p99s)
        self._tenants: Dict = {}

    # -- public counter views (kept as the pre-registry attribute API) ------
    @property
    def completed(self) -> int:
        return int(self._c_completed.total())

    @property
    def rejected(self) -> int:
        return int(self._c_rejected.total())

    @property
    def over_quota(self) -> int:
        return int(self._c_over_quota.total())

    @property
    def failed(self) -> int:
        return int(self._c_failed.total())

    @property
    def cancelled(self) -> int:
        return int(self._c_cancelled.total())

    @property
    def batches(self) -> int:
        return int(self._c_batches.total())

    @property
    def batched_samples(self) -> int:
        return int(self._c_real.total())

    @property
    def padded_samples(self) -> int:
        return int(self._c_padded.total())

    @property
    def max_queue_depth(self) -> int:
        return int(self._g_depth.value())

    def _tenant(self, tenant):
        t = self._tenants.get(tenant)
        if t is None:
            t = {"lat": deque(maxlen=self._window)}
            self._tenants[tenant] = t
        return t

    # -- recording ----------------------------------------------------------
    def record_request(self, latency_s: float, ok: bool = True,
                       tenant=None) -> None:
        with self._lock:
            if ok:
                self._c_completed.inc()
                self._lat.append(latency_s)
                self._h_lat.observe(latency_s * 1e3)
            else:
                self._c_failed.inc()
            if tenant is not None:
                self._c_tenant.inc(tenant=str(tenant),
                                   status="completed" if ok else "failed")
                t = self._tenant(tenant)
                if ok:
                    t["lat"].append(latency_s)

    def record_batch(self, n_real: int, bucket: int) -> None:
        with self._lock:
            self._c_batches.inc()
            self._c_real.inc(n_real)
            self._c_padded.inc(bucket - n_real)

    def record_rejected(self, tenant=None, over_quota: bool = False) -> None:
        """An admission rejection; ``over_quota=True`` marks a per-tenant
        quota rejection (``TenantOverQuota``) as opposed to a full shared
        queue (``ServeOverload``)."""
        with self._lock:
            self._c_rejected.inc()
            if over_quota:
                self._c_over_quota.inc()
            if tenant is not None:
                self._tenant(tenant)       # visible in tenant_snapshot
                self._c_tenant.inc(tenant=str(tenant), status="rejected")
                if over_quota:
                    self._c_tenant.inc(tenant=str(tenant),
                                       status="over_quota")

    def record_compile(self, artifact: str, bucket: int, seconds: float,
                       cached: bool = False) -> None:
        """One per-bucket executable build during warmup: ``seconds`` of
        cold-start cost (on the card: the warm-up runs and the CUDA-graph
        capture), ``cached=True`` when a compile cache held the bucket's
        warm record (the capture was then checked against it)."""
        with self._lock:
            key = "true" if cached else "false"
            self._c_compile.inc(cached=key)
            self._c_compile_s.inc(float(seconds), cached=key)

    def record_cancelled(self) -> None:
        """Client cancelled the future while the request was queued."""
        with self._lock:
            self._c_cancelled.inc()

    def observe_queue_depth(self, depth: int) -> None:
        with self._lock:
            self._g_depth.max(depth)

    def reset_clock(self) -> None:
        """Restart the throughput window (e.g. right after warmup) without
        dropping rejection/failure counters."""
        with self._lock:
            self._t0 = time.perf_counter()
            self._c_completed.reset()
            self._lat.clear()
            for t in self._tenants.values():
                t["lat"].clear()

    # -- reading ------------------------------------------------------------
    def compile_snapshot(self) -> Dict[str, float]:
        """Cold-start cost: total warmup seconds, per-bucket event count,
        and how many of those were cache restores vs fresh compiles."""
        with self._lock:
            return {
                "compile_events": self._c_compile.total(),
                "compile_s": self._c_compile_s.total(),
                "compile_cached": self._c_compile.value(cached="true"),
                "compile_fresh_s": self._c_compile_s.value(cached="false"),
            }

    def tenant_snapshot(self) -> Dict:
        """Per-tenant counters + latency percentiles (the noisy-neighbor
        acceptance numbers)."""
        with self._lock:
            out = {}
            for tenant, t in self._tenants.items():
                lat = sorted(t["lat"])
                out[tenant] = {
                    "completed": self._c_tenant.value(
                        tenant=str(tenant), status="completed"),
                    "rejected": self._c_tenant.value(
                        tenant=str(tenant), status="rejected"),
                    "over_quota": self._c_tenant.value(
                        tenant=str(tenant), status="over_quota"),
                    "failed": self._c_tenant.value(
                        tenant=str(tenant), status="failed"),
                    "p50_ms": percentile(lat, 50) * 1e3,
                    "p95_ms": percentile(lat, 95) * 1e3,
                    "p99_ms": percentile(lat, 99) * 1e3,
                }
            return out

    def snapshot(self) -> Dict[str, float]:
        with self._lock:
            lat = sorted(self._lat)
            elapsed = max(time.perf_counter() - self._t0, 1e-9)
            completed = self._c_completed.total()
            batches = self._c_batches.total()
            real = self._c_real.total()
            padded = self._c_padded.total()
            return {
                "completed": completed,
                "rejected": self._c_rejected.total(),
                "over_quota": self._c_over_quota.total(),
                "failed": self._c_failed.total(),
                "cancelled": self._c_cancelled.total(),
                "batches": batches,
                "mean_batch": (real / batches if batches else float("nan")),
                "padded_frac": padded / max(real + padded, 1),
                "max_queue_depth": self._g_depth.value(),
                "throughput_rps": completed / elapsed,
                "p50_ms": percentile(lat, 50) * 1e3,
                "p95_ms": percentile(lat, 95) * 1e3,
                "p99_ms": percentile(lat, 99) * 1e3,
            }

    def prometheus(self) -> str:
        """The whole registry in Prometheus text exposition format."""
        return self.registry.render()

    def report(self) -> str:
        s = self.snapshot()
        return (f"serve: {int(s['completed'])} ok / {int(s['rejected'])} "
                f"rejected / {int(s['failed'])} failed | "
                f"{s['throughput_rps']:.1f} req/s | "
                f"p50 {s['p50_ms']:.2f} ms, p95 {s['p95_ms']:.2f} ms, "
                f"p99 {s['p99_ms']:.2f} ms | mean batch {s['mean_batch']:.1f} "
                f"(pad {s['padded_frac']:.0%}), "
                f"queue<= {int(s['max_queue_depth'])}")
