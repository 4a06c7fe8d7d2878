"""Multi-artifact registry — several compiled backbones served side by side.

The port's copy of the JAX package's ``serve/registry.py``.  Each artifact
(e.g. ``w6a4-int``, ``w8a8-int``, the ``f32`` reference) registers under a
name together with its OWN :class:`PrototypeStore` (features from different
numeric grids must never share prototypes).  ``set_default`` /
``register(..., default=True)`` hot-swaps which artifact anonymous requests
hit — a single reference assignment under the lock, atomic with respect to
the engine's per-batch ``get()``: every batch runs wholly on the old or
wholly on the new artifact, never a mix.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Any, Callable, Dict, Optional, Tuple

from repro_torch.device import DeviceLike
from repro_torch.serve.store import PrototypeStore
from repro_torch.serve.workload import default_adapter

__all__ = ["ArtifactRegistry", "ServedArtifact"]


@dataclasses.dataclass(frozen=True)
class ServedArtifact:
    """One servable backbone: a batched feature fn + its prototype state.

    ``feats`` is any ``(n, H, W, C) -> (n, D)`` callable —
    ``FSLPipeline.deploy()``'s flip-ensemble function or a raw
    ``DeployedModel``.  ``trace_count``/``warmup`` hooks are read off the
    callable when present (the engine's zero-retrace accounting: on the
    card, CUDA-graph captures).

    ``meta`` is caller-provided provenance (why this artifact is served);
    the engine never reads it.  ``adapter`` picks the workload (request
    kinds, batching, warmup); ``None`` means the default few-shot
    :class:`~repro_torch.serve.workload.FSLAdapter`.
    """

    name: str
    feats: Callable
    store: PrototypeStore
    meta: Dict[str, Any] = dataclasses.field(default_factory=dict)
    adapter: Optional[Any] = None

    def trace_count(self) -> Optional[int]:
        fn = getattr(self.feats, "trace_count", None)
        if fn is not None:
            return int(fn() if callable(fn) else fn)
        dm = getattr(self.feats, "deployed_model", None)
        return int(dm.trace_count) if dm is not None else None

    def warmup(self, buckets, img: int, cache=None, metrics=None) -> None:
        """Warm every bucket executable — delegated to the artifact's
        workload adapter (the default FSL adapter warms the
        DeployedModel/pipeline graphs and primes the store's head)."""
        ad = self.adapter if self.adapter is not None else default_adapter()
        ad.warmup(self, buckets, img=img, cache=cache, metrics=metrics)


class ArtifactRegistry:
    """Named, hot-swappable set of :class:`ServedArtifact`."""

    def __init__(self):
        self._lock = threading.Lock()
        self._artifacts: Dict[str, ServedArtifact] = {}
        self._default: Optional[str] = None

    def register(self, name: str, feats: Callable, *,
                 store: Optional[PrototypeStore] = None,
                 default: bool = False,
                 meta: Optional[Dict[str, Any]] = None,
                 adapter: Optional[Any] = None,
                 device: DeviceLike = None) -> ServedArtifact:
        """Add (or atomically replace) an artifact.  The first registration
        becomes the default; ``default=True`` swaps it explicitly.  ``meta``
        attaches provenance readable via :meth:`metadata`.  ``adapter``
        selects a non-default workload.

        Without a ``store``, the artifact gets a fresh
        :class:`PrototypeStore` on ``device``, or else on the feats
        callable's own ``device`` (a ``DeployedModel``'s, or a
        ``FSLPipeline.deploy`` function's), or else on the card."""
        if store is None:
            store = PrototypeStore(
                device if device is not None else getattr(feats, "device",
                                                          None))
        art = ServedArtifact(name, feats, store, dict(meta or {}), adapter)
        with self._lock:
            self._artifacts[name] = art
            if default or self._default is None:
                self._default = name
        return art

    def metadata(self) -> Dict[str, Dict[str, Any]]:
        """Per-artifact provenance metadata (copies — safe to mutate)."""
        with self._lock:
            return {a.name: dict(a.meta) for a in self._artifacts.values()}

    def set_default(self, name: str) -> None:
        with self._lock:
            if name not in self._artifacts:
                raise KeyError(f"unknown artifact {name!r}; have "
                               f"{sorted(self._artifacts)}")
            self._default = name

    @property
    def default_name(self) -> Optional[str]:
        with self._lock:
            return self._default

    def get(self, name: Optional[str] = None) -> ServedArtifact:
        with self._lock:
            key = name if name is not None else self._default
            if key is None:
                raise KeyError("registry is empty — register an artifact")
            try:
                return self._artifacts[key]
            except KeyError:
                raise KeyError(f"unknown artifact {key!r}; have "
                               f"{sorted(self._artifacts)}") from None

    def names(self) -> Tuple[str, ...]:
        with self._lock:
            return tuple(sorted(self._artifacts))

    def __len__(self) -> int:
        with self._lock:
            return len(self._artifacts)

    def trace_counts(self) -> Dict[str, Optional[int]]:
        with self._lock:
            arts = list(self._artifacts.values())
        return {a.name: a.trace_count() for a in arts}
