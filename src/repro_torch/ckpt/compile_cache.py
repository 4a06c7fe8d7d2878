"""Persistent compile cache: content-keyed warm records of the artifacts'
CUDA graphs, and graph fingerprints, the artifact half of the key.

Counterpart of the JAX package's ``ckpt/compile_cache.py``, with its whole
contract: :meth:`CompileCache.key` over caller parts plus an environment
record, ``store`` / ``load`` / ``has`` / ``keys`` / ``evict``,
``get_or_compile`` returning ``(value, hit, seconds)``, and ``stats()``
with the reference's five counters.  Entries ride
:meth:`CheckpointManager.save_named` (atomic, never collected, safe under
concurrent writers of one key).

What an entry holds differs, by design.  The reference serializes XLA
executables, so a restored replica traces nothing.  A captured CUDA graph
has no serialized form, so the port persists a *verified warm record* per
warmed bucket (:class:`~repro_torch.core.cudagraph.GraphTable`): the
bucket, its input signature, the warm seconds, and the SHA-256 of the
outputs of the first replay on the bucket's zero batch (of the eager run
on the CPU).  A restored replica warms and captures again (the warm-up
runs also size the split-K tile counters), then checks its first replay
against the record: a replica that computes differently from the one that
published the record raises :class:`WarmDigestMismatch`.  Captures at
restore therefore count in ``trace_count``.  The kernel library itself is
cached on disk by its digest (``kernels.build``).

Entries are numpy arrays plus JSON metadata; nothing of CUDA is pickled.
The key folds in the device's name and compute capability (or ``"cpu"``),
``torch.__version__``, ``torch.version.cuda`` and the kernel library's
source digest: a change in any of them is a clean miss, never a wrong hit.
A present entry that fails to load is evicted and counted as a miss.
"""

from __future__ import annotations

import hashlib
import shutil
import time
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.ckpt.manager import CheckpointManager, content_key

__all__ = ["CompileCache", "WarmDigestMismatch", "graph_fingerprint",
           "output_digest"]


def _hash_update_array(h, arr: Any) -> None:
    if isinstance(arr, torch.Tensor):
        arr = arr.detach().cpu().numpy()
    arr = np.ascontiguousarray(arr)
    h.update(str(arr.dtype).encode())
    h.update(repr(arr.shape).encode())
    h.update(arr.tobytes())


def graph_fingerprint(graph) -> str:
    """Content digest of a :class:`repro_torch.core.graph.Graph`: inputs,
    outputs, node ops + wiring + attrs (arrays by dtype, shape and bytes,
    anything else by ``repr``) and the raw initializer bytes.  Two graphs
    fingerprint equal iff they lower to the same program over the same
    constants; the graph's name is excluded."""
    h = hashlib.sha256()
    h.update(repr(tuple(graph.inputs)).encode())
    h.update(repr(tuple(graph.outputs)).encode())
    for node in graph.nodes:
        h.update(node.op.encode())
        h.update(repr(tuple(node.inputs)).encode())
        h.update(repr(tuple(node.outputs)).encode())
        for key in sorted(node.attrs):
            val = node.attrs[key]
            h.update(key.encode())
            if isinstance(val, (np.ndarray, torch.Tensor)):
                _hash_update_array(h, val)
            else:
                h.update(repr(val).encode())
    for name in sorted(graph.initializers):
        h.update(name.encode())
        _hash_update_array(h, graph.initializers[name])
    return h.hexdigest()[:16]


class WarmDigestMismatch(RuntimeError):
    """A restored bucket's first replay differs from the stored record."""


def output_digest(outputs: Sequence[torch.Tensor]) -> str:
    """SHA-256 over each output's dtype, shape and raw bytes, in order."""
    h = hashlib.sha256()
    for t in outputs:
        t = t.detach().contiguous()
        h.update(str(t.dtype).encode())
        h.update(repr(tuple(t.shape)).encode())
        h.update(t.reshape(-1).view(torch.uint8).cpu().numpy().tobytes())
    return h.hexdigest()


def _env_fingerprint(device: Any = None) -> Dict[str, Any]:
    """What a warm record must not outlive: the device (name and compute
    capability, or ``"cpu"``), the torch and CUDA versions and the kernel
    sources.  ``device=None`` describes the process's default device: the
    card when there is one."""
    from repro_torch.kernels.build import _digest

    dev = torch.device(device) if device is not None else torch.device(
        "cuda" if torch.cuda.is_available() else "cpu")
    if dev.type == "cuda":
        idx = dev.index if dev.index is not None else \
            torch.cuda.current_device()
        name = torch.cuda.get_device_name(idx)
        cap = ".".join(map(str, torch.cuda.get_device_capability(idx)))
    else:
        name, cap = dev.type, None
    return {"device": name, "capability": cap, "torch": torch.__version__,
            "cuda": torch.version.cuda, "kernels": _digest()}


class CompileCache:
    """Persistent, content-keyed store of warm records.

    A value is a flat dict: its numpy arrays go to the entry's
    ``arrays.npz``, every other (JSON-able) item to its ``meta.json``, and
    :meth:`load` gives the same dict back.  Typical use (see
    ``DeployedModel.warmup``)::

        cache = CompileCache("/var/cache/repro-torch")
        key = cache.key(kind="deployed-model", graph=dm.fingerprint(),
                        shape=[16, 32, 32, 3], dtype="float32",
                        device=dm.device)
        record, hit, seconds = cache.get_or_compile(key, warm_fn)
    """

    def __init__(self, directory: str):
        self.mgr = CheckpointManager(directory, keep=0)
        self.hits = 0
        self.misses = 0
        self.stores = 0
        self.load_errors = 0

    # -- keying -------------------------------------------------------------
    def key(self, *, device: Any = None, **parts: Any) -> str:
        """Content key over the caller's identity parts plus the environment
        record of ``device`` (the device the entry's artifact runs on;
        default: the card when there is one, else the CPU)."""
        blob = dict(parts)
        blob["__env__"] = _env_fingerprint(device)
        return content_key(blob)

    # -- store / load -------------------------------------------------------
    def store(self, key: str, value: Dict[str, Any],
              meta: Optional[Dict] = None) -> str:
        """Publish ``value`` (numpy arrays and JSON-able items) under
        ``key``."""
        arrays = {k: v for k, v in value.items() if isinstance(v, np.ndarray)}
        rest = {k: v for k, v in value.items() if k not in arrays}
        path = self.mgr.save_named(
            key, arrays, meta={**(meta or {}), "arrays": sorted(arrays),
                               "value": rest})
        self.stores += 1
        return path

    def load(self, key: str) -> Optional[Dict[str, Any]]:
        """The value under ``key``; ``None`` on a miss.  A present entry
        that fails to load (truncated, foreign, overwritten) is evicted and
        counted as a miss: the cache may only make a cold start faster,
        never wronger."""
        if not self.mgr.has_named(key):
            self.misses += 1
            return None
        try:
            meta = self.mgr.named_meta(key)
            like = {k: np.zeros((0,), np.uint8) for k in meta["arrays"]}
            arrays = self.mgr.restore_named(like, key) if like else {}
            value = {**dict(meta["value"]), **arrays}
        except Exception:                              # noqa: BLE001
            self.load_errors += 1
            self.misses += 1
            self.evict(key)
            return None
        self.hits += 1
        return value

    def get_or_compile(self, key: str, compile_fn: Callable[[], Dict],
                       meta: Optional[Dict] = None
                       ) -> Tuple[Dict[str, Any], bool, float]:
        """Load ``key`` or run ``compile_fn`` and publish what it returns.
        Returns ``(value, cache_hit, seconds)``, ``seconds`` the wall-clock
        of whichever path ran."""
        t0 = time.perf_counter()
        value = self.load(key)
        if value is not None:
            return value, True, time.perf_counter() - t0
        value = compile_fn()
        self.store(key, value, meta=meta)
        return value, False, time.perf_counter() - t0

    # -- bookkeeping --------------------------------------------------------
    def has(self, key: str) -> bool:
        return self.mgr.has_named(key)

    def keys(self) -> Tuple[str, ...]:
        return tuple(self.mgr.all_named())

    def evict(self, key: str) -> None:
        if self.mgr.has_named(key):
            shutil.rmtree(self.mgr._named_dir(key), ignore_errors=True)

    def stats(self) -> Dict[str, int]:
        return {"hits": self.hits, "misses": self.misses,
                "stores": self.stores, "load_errors": self.load_errors,
                "entries": len(self.keys())}
