"""Workload adapters — what a served artifact can DO, as data.

The port's copy of the JAX package's ``serve/workload.py``.  The engine is
workload-agnostic; each :class:`~repro_torch.serve.registry.ServedArtifact`
carries an adapter that says what its requests mean:

* :class:`RequestKind` — one admissible request type: its payload
  validator (runs at ``submit`` time, in the caller's thread, so bad
  payloads raise immediately instead of failing a future) and its row
  count (what the request contributes to a coalesced batch).
* :class:`ArtifactAdapter` — the engine-facing protocol: a ``kinds``
  table, a ``group_key`` for coalescing compatible artifacts into one
  executable launch, a ``warmup`` hook, and ``run_group`` — the only
  place a workload touches its artifact's executables.
* :class:`FSLAdapter` — the few-shot workload (register / classify).
  Artifacts registered without an adapter get it by default.

On the card a coalesced batch is padded on the host, copied to the card
once, and run as one replay of the bucket's CUDA graph; the features stay
on the card for the artifact's :class:`PrototypeStore`, and only the
classify similarities cross back, as numpy.

Import discipline: this module must not import ``repro_torch.serve.engine``
or ``repro_torch.serve.registry`` (both import it); adapters receive the
engine and artifact as arguments instead.
"""

from __future__ import annotations

import dataclasses
import inspect
import time
from typing import Any, Callable, Dict, Hashable, List, Mapping, Tuple

import numpy as np
import torch

from repro_torch.core.deploy import DeployedModel
from repro_torch.serve.bucketing import pad_to_bucket

__all__ = ["ArtifactAdapter", "ClassifyResult", "FSLAdapter", "RequestKind",
           "default_adapter"]


@dataclasses.dataclass(frozen=True)
class ClassifyResult:
    """Per-query predictions against the artifact's current store."""

    class_ids: List[Hashable]       # len n, registered class ids
    sims: np.ndarray                # (n, C) cosine similarities
    artifact: str


@dataclasses.dataclass(frozen=True)
class RequestKind:
    """One request type an adapter accepts.

    ``validate(payload, engine)`` runs synchronously at submit time and
    returns the normalized payload (or raises ``ValueError`` /
    ``TypeError`` straight into the caller).  ``rows(payload)`` is the
    request's batch-row footprint — the engine coalesces until row sums
    hit ``max_batch`` and rejects single requests exceeding it.
    """

    name: str
    validate: Callable[[Any, Any], Any]
    rows: Callable[[Any], int]
    doc: str = ""


class ArtifactAdapter:
    """Protocol between :class:`ServeEngine` and one workload family.

    Subclasses populate ``kinds`` and implement :meth:`run_group`; the
    engine calls adapter methods only from its worker thread (plus
    ``validate`` from submitter threads — keep validators pure).
    """

    #: request kinds this workload admits, by name
    kinds: Mapping[str, RequestKind] = {}

    def group_key(self, art: Any) -> Hashable:
        """Requests whose artifacts share ``(adapter, group_key)`` may be
        coalesced into one ``run_group`` call.  Default: identity of the
        feats callable — views of one backbone share its graphs and should
        share batches."""
        return id(art.feats)

    def warmup(self, art: Any, buckets, *, img: int = 32, cache=None,
               metrics=None) -> None:
        """Warm every bucket executable for ``art``.  Optional."""

    def run_group(self, engine: Any, pairs: List[Tuple[Any, Any]]) -> None:
        """Serve one coalesced group of ``(artifact, request)`` pairs, in
        arrival order, resolving each request via ``engine._fulfill`` /
        ``engine._fail`` (every request must end in exactly one of them)."""
        raise NotImplementedError


# -- the few-shot workload ----------------------------------------------------

def _validate_images(payload: Dict[str, Any], engine: Any) -> Dict[str, Any]:
    x = np.asarray(payload["x"], np.float32)
    if x.ndim == 3:
        x = x[None]
    if x.ndim != 4 or x.shape[0] == 0:
        raise ValueError(f"expected (n, H, W, C) images, got {x.shape}")
    return {**payload, "x": x}


def _image_rows(payload: Dict[str, Any]) -> int:
    return int(payload["x"].shape[0])


def _features(out) -> Any:
    """A feats callable's result as rows: a tensor stays where it is (on
    the card, for the store there), anything else becomes numpy."""
    return out if isinstance(out, torch.Tensor) else np.asarray(out)


class FSLAdapter(ArtifactAdapter):
    """Few-shot register/classify over a batched feature extractor.

    Stateless (all state lives on the artifact's store), so one shared
    instance serves every FSL artifact.
    """

    kinds = {
        "register": RequestKind(
            "register", _validate_images, _image_rows,
            doc="payload {'class_id', 'x': (k, H, W, C)} -> new shot count"),
        "classify": RequestKind(
            "classify", _validate_images, _image_rows,
            doc="payload {'x': (n, H, W, C)} -> ClassifyResult"),
    }

    def warmup(self, art: Any, buckets, *, img: int = 32, cache=None,
               metrics=None) -> None:
        """Warm every bucket executable (on the card: capture its CUDA
        graph), then prime the store's classify head for the same bucket
        set.  The ``cache``/``metrics`` extras are forwarded when the feats
        callable understands them (``DeployedModel`` and
        ``FSLPipeline.deploy`` functions do); plain warmup callables keep
        the two-argument contract."""
        if isinstance(art.feats, DeployedModel):
            art.feats.warmup(
                buckets, example=np.zeros((1, img, img, 3), np.float32),
                cache=cache, metrics=metrics, label=art.name)
        else:
            fn = getattr(art.feats, "warmup", None)
            if fn is not None:
                try:
                    accepts = "cache" in inspect.signature(fn).parameters
                except (TypeError, ValueError):
                    accepts = False
                if accepts:
                    fn(buckets, img=img, cache=cache, metrics=metrics,
                       label=art.name)
                else:
                    fn(buckets, img=img)
        # probe the feature dim off the smallest bucket (a replay once the
        # bucket is warm) and run the store's head once per bucket, so the
        # first classify finds warm kernels.  Best-effort: feats callables
        # that can't take an image batch just skip it.
        try:
            small = min(int(b) for b in buckets)
            feat = _features(art.feats(
                np.zeros((small, img, img, 3), np.float32)))
            art.store.prime(int(feat.shape[-1]), buckets)
        except Exception:
            pass

    def run_group(self, engine: Any, pairs: List[Tuple[Any, Any]]) -> None:
        reqs = [r for _, r in pairs]
        t_g0 = time.perf_counter()
        try:
            xs = [r.payload["x"] for r in reqs]
            x = np.concatenate(xs, axis=0) if len(xs) > 1 else xs[0]
            padded, n_real, bucket = pad_to_bucket(x, engine.buckets)
            t_x0 = time.perf_counter()
            feats = _features(pairs[0][0].feats(padded))[:n_real]
            if isinstance(feats, torch.Tensor) and feats.is_cuda:
                # the exec span ends when the features exist, as the
                # reference's np.asarray waits for them
                torch.cuda.current_stream(feats.device).synchronize()
            t_x1 = time.perf_counter()
            engine.metrics.record_batch(n_real, bucket)
        except Exception as e:                        # noqa: BLE001
            for r in reqs:
                engine._fail(r, e)
            return
        for r in reqs:
            r.t_exec1 = t_x1
        tr = engine.tracer
        if tr.enabled:
            # one batch-scope span on its own trace (the padding-overhead
            # view), plus queue/coalesce/exec children on each request's
            # trace — all post-hoc from timestamps the worker already
            # holds, pushed in ONE record_many call
            evs = [("serve.batch", t_g0, t_x1, tr.new_trace("batch"),
                    None, None, None,
                    {"n_real": n_real, "bucket": bucket,
                     "padded": bucket - n_real, "requests": len(reqs),
                     "artifact": pairs[0][0].name})]
            for art, r in pairs:
                root = r.trace + "-00"
                evs.append(("serve.queue", r.t_enq, r.t_deq, r.trace,
                            root, None, None, None))
                evs.append(("serve.coalesce", r.t_deq, t_x0, r.trace,
                            root, None, None, None))
                evs.append(("serve.exec", t_x0, t_x1, r.trace, root,
                            None, None,
                            {"bucket": bucket, "n_real": n_real,
                             "artifact": art.name, "tenant": r.tenant}))
            tr.record_many(evs)
        # Strict arrival order, but consecutive classifies on the SAME
        # artifact between two of its registers see the SAME store state —
        # classify them as ONE run (one NCM head call per run, not per
        # request).  A run must stay slice-contiguous in ``feats``, so any
        # intervening request — a register, or another artifact's classify
        # — flushes it.
        run: List[Tuple[Any, int, int]] = []         # (req, start, end)
        run_art: Any = None

        def flush_run() -> None:
            nonlocal run_art
            art, run_art = run_art, None
            if not run:
                return
            lo, hi = run[0][1], run[-1][2]
            try:
                ids, sims = art.store.classify(feats[lo:hi])
            except Exception as exc:                  # noqa: BLE001
                for r, _, _ in run:
                    engine._fail(r, exc)
                run.clear()
                return
            for r, s, e in run:
                engine._fulfill(r, ClassifyResult(
                    ids[s - lo:e - lo], sims[s - lo:e - lo], art.name))
            run.clear()

        off = 0
        for art, r in pairs:
            start, off = off, off + r.n
            if r.kind == "classify":
                if run and run_art is not art:
                    flush_run()
                run_art = art
                run.append((r, start, off))
                continue
            flush_run()
            try:
                out = art.store.register(r.payload["class_id"],
                                         feats[start:off])
            except Exception as exc:                  # noqa: BLE001
                engine._fail(r, exc)
                continue
            engine._fulfill(r, out)
        flush_run()


_DEFAULT_FSL = FSLAdapter()


def default_adapter() -> FSLAdapter:
    """The adapter artifacts get when registered without one (few-shot
    register/classify)."""
    return _DEFAULT_FSL
