"""Quantized LM decode serving: the engine's second workload.

The port's copy of the JAX package's ``serve/decode.py``.
:class:`~repro_torch.serve.engine.ServeEngine` knows nothing about language
models, yet serves greedy decode with the same admission queue, tenant
quotas, request tracing, metrics and dynamic batching as few-shot
classify: the workload lives in a :class:`DecodeAdapter` and a
:class:`DecodeArtifact` wrapping one compiled
:class:`~repro_torch.core.deploy.DeployedModel` of the decode-step graph.

Shape discipline: the decode graph takes any KV capacity, so the artifact
warms one signature per (batch bucket x KV-capacity bucket) at warmup, on
the card one CUDA graph each.  Live sequences are grouped by capacity,
each group padded to a warmed batch bucket, and a sequence whose position
reaches its capacity is grown to the next capacity bucket *before*
stepping, so after warmup nothing is captured or run eagerly
(``trace_count`` stays flat).

Each sequence's KV cache lives on the artifact's device as one
``(capacity, d_model)`` tensor per layer for K and for V; a step stacks
the group's rows into the graph's inputs and keeps the rows of its
outputs, so no cache crosses to the host.  Only each step's logits rows
come back, as numpy, as the reference's results carry them.

Request kinds:

* ``prefill``  — ``{"seq", "tokens", "reserve"?}``: start a sequence,
  feed the prompt through the decode step one position at a time (bit for
  bit the serving datapath) and resolve to the first predicted token.
* ``decode``   — ``{"seq", "token"?}``: advance one position.  Without a
  token the sequence feeds its own last prediction (greedy).
* ``release``  — ``{"seq"}``: drop the sequence's KV state.

``greedy_generate`` is the client loop over those kinds;
``build_decode_artifact`` compiles the graph with ``repro_torch.compile``
and the ``lm-decode`` recipe, checked against the interpreter after every
pass (bit for bit).
"""

from __future__ import annotations

import dataclasses
import itertools
import threading
import time
from typing import Any, Dict, Hashable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.deploy import bucket_for, normalize_buckets
from repro_torch.device import DeviceLike
from repro_torch.serve.workload import ArtifactAdapter, RequestKind

__all__ = ["DecodeAdapter", "DecodeArtifact", "DecodeResult",
           "PrefillResult", "build_decode_artifact", "greedy_generate"]


@dataclasses.dataclass(frozen=True)
class PrefillResult:
    """Prompt consumed; ``token`` is the first greedy continuation."""

    seq: Hashable
    token: int
    pos: int                        # next write position (== prompt length)
    logits: np.ndarray              # (vocab,) at the last prompt position
    artifact: str


@dataclasses.dataclass(frozen=True)
class DecodeResult:
    """One decode step; ``token`` is the next greedy prediction."""

    seq: Hashable
    token: int
    pos: int
    logits: np.ndarray
    artifact: str


class DecodeArtifact:
    """Per-sequence KV state + bucketed dispatch over one decode model.

    ``dm`` is the compiled decode-step :class:`DeployedModel` with inputs
    ``(tokens, pos, k0, v0, ...)`` and outputs ``(logits, k0_out, ...)``.
    KV caches live here, on ``dm``'s device, one ``(capacity, d_model)``
    tensor per layer for K and V per sequence: the model stays pure, so one
    artifact serves any number of concurrent sequences and the engine's
    worker is the only mutator.

    ``dm_prefill`` (optional) is the fused whole-prompt model; the serving
    path does not use it (stepping the decode model is already bit for
    bit) but it rides along for offline comparison.
    """

    def __init__(self, dm: Any, d_model: int, *,
                 capacities: Sequence[int] = (32, 64),
                 vocab: Optional[int] = None,
                 dm_prefill: Optional[Any] = None):
        self.dm = dm
        self.dm_prefill = dm_prefill
        self.device = dm.device
        self.d_model = int(d_model)
        self.capacities = normalize_buckets(capacities)
        self.vocab = int(vocab) if vocab is not None else None
        names = list(dm.input_names)
        if len(names) < 4 or names[:2] != ["tokens", "pos"] \
                or (len(names) - 2) % 2:
            raise ValueError(f"not a decode graph: inputs {names}")
        self.n_layers = (len(names) - 2) // 2
        self._lock = threading.Lock()
        self._seqs: Dict[Hashable, Dict[str, Any]] = {}

    # -- sequence lifecycle --------------------------------------------------
    def has(self, seq: Hashable) -> bool:
        with self._lock:
            return seq in self._seqs

    def sequences(self) -> Tuple[Hashable, ...]:
        with self._lock:
            return tuple(self._seqs)

    def release(self, seq: Hashable) -> int:
        """Drop ``seq``'s KV state; returns its final position."""
        with self._lock:
            st = self._seqs.pop(seq, None)
        if st is None:
            raise KeyError(f"unknown sequence {seq!r}")
        return st["pos"]

    def _zeros(self, *shape: int) -> torch.Tensor:
        return torch.zeros(shape, dtype=torch.float32, device=self.device)

    def _new_state(self, capacity: int) -> Dict[str, Any]:
        return {"k": [self._zeros(capacity, self.d_model)
                      for _ in range(self.n_layers)],
                "v": [self._zeros(capacity, self.d_model)
                      for _ in range(self.n_layers)],
                "pos": 0, "cap": capacity, "last": None}

    def _grow(self, st: Dict[str, Any]) -> None:
        """Move a full sequence to the next capacity bucket (zero rows: they
        sit beyond the causal mask, so growth changes no result)."""
        bigger = [c for c in self.capacities if c > st["cap"]]
        if not bigger:
            raise RuntimeError(
                f"sequence at position {st['pos']} exceeds the largest KV "
                f"capacity {self.capacities[-1]}; raise capacities")
        cap = bigger[0]
        pad = (0, 0, 0, cap - st["cap"])
        st["k"] = [torch.nn.functional.pad(a, pad) for a in st["k"]]
        st["v"] = [torch.nn.functional.pad(a, pad) for a in st["v"]]
        st["cap"] = cap

    # -- stepping ------------------------------------------------------------
    def _batch_buckets(self) -> Optional[Tuple[int, ...]]:
        return self.dm.buckets

    def _step_group(self, items: List[Tuple[Dict[str, Any], int]]
                    ) -> Tuple[List[Tuple[int, int, np.ndarray]],
                               Tuple[int, int]]:
        """One launch of the decode model: step ``(state, token)`` pairs
        that share a capacity.  Returns per-item ``(token, pos, logits)``
        plus the ``(n_real, bucket)`` batch stats."""
        cap = items[0][0]["cap"]
        n = len(items)
        bs = self._batch_buckets()
        bucket = bucket_for(n, bs) if bs else n
        feeds: Dict[str, Any] = {
            "tokens": np.zeros((bucket,), np.int32),
            "pos": np.zeros((bucket,), np.int32),
        }
        for b, (st, tok) in enumerate(items):
            feeds["tokens"][b] = tok
            feeds["pos"][b] = st["pos"]
        pad = [self._zeros(cap, self.d_model)] * (bucket - n)
        for li in range(self.n_layers):
            for kv in ("k", "v"):
                feeds[f"{kv}{li}"] = torch.stack(
                    [st[kv][li] for st, _ in items] + pad)
        outs = self.dm(**feeds)
        logits = outs[0][:n].cpu().numpy()
        caches = {nm: outs[i + 1]
                  for i, nm in enumerate(self.dm.output_names[1:])}
        out: List[Tuple[int, int, np.ndarray]] = []
        for b, (st, tok) in enumerate(items):
            for li in range(self.n_layers):
                st["k"][li] = caches[f"k{li}_out"][b]
                st["v"][li] = caches[f"v{li}_out"][b]
            st["pos"] += 1
            row = logits[b, :self.vocab] if self.vocab else logits[b]
            nxt = int(np.argmax(row))
            st["last"] = nxt
            out.append((nxt, st["pos"], row))
        return out, (n, bucket)

    def start_sequence(self, seq: Hashable, tokens, *,
                       reserve: Optional[int] = None
                       ) -> Tuple[int, int, np.ndarray]:
        """Create ``seq`` and feed the prompt position by position through
        the decode model (the serving datapath itself, so the result is bit
        for bit what stepping would produce).  Returns ``(next_token, pos,
        logits)`` at the last prompt position."""
        toks = np.asarray(tokens, np.int32).ravel()
        if toks.size == 0:
            raise ValueError("prompt must be non-empty")
        need = max(int(reserve or 0), int(toks.size) + 1)
        fit = [c for c in self.capacities if c >= min(need,
                                                     self.capacities[-1])]
        st = self._new_state(fit[0] if fit else self.capacities[0])
        with self._lock:
            if seq in self._seqs:
                raise ValueError(f"sequence {seq!r} already active; "
                                 f"release it first")
            self._seqs[seq] = st
        last: Tuple[int, int, np.ndarray] = (0, 0, np.zeros(0, np.float32))
        for t in toks:
            if st["pos"] >= st["cap"]:
                self._grow(st)
            (last,), _ = self._step_group([(st, int(t))])
        return last

    def step_sequences(self, items: Sequence[Tuple[Hashable, Optional[int]]]
                       ) -> Tuple[List[Tuple[Hashable, int, int, np.ndarray]],
                                  List[Tuple[int, int]]]:
        """Advance each ``(seq, token)`` one position — ``token=None`` feeds
        the sequence's own last prediction (greedy).  Groups by capacity
        (after any needed growth), one launch per group chunk.  Returns
        per-item ``(seq, next_token, pos, logits)`` in input order plus
        ``(n_real, bucket)`` stats per launch."""
        with self._lock:
            states = []
            for seq, tok in items:
                st = self._seqs.get(seq)
                if st is None:
                    raise KeyError(f"unknown sequence {seq!r}")
                states.append(st)
        groups: Dict[int, List[int]] = {}
        for i, ((seq, tok), st) in enumerate(zip(items, states)):
            if tok is None and st["last"] is None:
                raise ValueError(f"sequence {seq!r} has no last prediction; "
                                 f"pass an explicit token")
            if st["pos"] >= st["cap"]:
                self._grow(st)
            groups.setdefault(st["cap"], []).append(i)
        results: List[Optional[Tuple[Hashable, int, int, np.ndarray]]] = \
            [None] * len(items)
        stats: List[Tuple[int, int]] = []
        bs = self._batch_buckets()
        chunk = bs[-1] if bs else len(items) or 1
        for idxs in groups.values():
            for at in range(0, len(idxs), chunk):
                part = idxs[at:at + chunk]
                batch = []
                for i in part:
                    seq, tok = items[i]
                    st = states[i]
                    batch.append((st, int(tok) if tok is not None
                                  else int(st["last"])))
                out, stat = self._step_group(batch)
                stats.append(stat)
                for i, (nxt, pos, row) in zip(part, out):
                    results[i] = (items[i][0], nxt, pos, row)
        return [r for r in results if r is not None], stats

    # feats-callable convention: calling the artifact IS the decode step
    __call__ = step_sequences

    # -- engine hooks --------------------------------------------------------
    def warmup(self, buckets, *, img: int = 32, cache=None, metrics=None,
               label: Optional[str] = None) -> None:
        """Warm one signature per (batch bucket x capacity): on the card one
        CUDA graph each.  ``img`` is part of the registry's warmup
        signature and ignored (decode shapes come from ``d_model`` and
        ``capacities``).  ``cache`` (a ``CompileCache``) goes to
        :meth:`DeployedModel.warmup`: one warm record per (bucket,
        capacity), checked at a restore."""
        name = label or "decode"
        for cap in self.capacities:
            ex = []
            for nm in self.dm.input_names:
                if nm in ("tokens", "pos"):
                    ex.append(np.zeros((1,), np.int32))
                else:
                    ex.append(np.zeros((1, cap, self.d_model), np.float32))
            self.dm.warmup(buckets, tuple(ex), cache=cache, metrics=metrics,
                           label=f"{name}@c{cap}")

    def trace_count(self) -> int:
        n = int(self.dm.trace_count)
        if self.dm_prefill is not None:
            n += int(self.dm_prefill.trace_count)
        return n

    def weight_bytes(self) -> int:
        return int(self.dm.weight_bytes())


# -- the adapter -------------------------------------------------------------

def _need(payload: Any, *keys: str) -> Dict[str, Any]:
    if not isinstance(payload, dict):
        raise ValueError(f"decode payloads are dicts, got {type(payload)}")
    for k in keys:
        if k not in payload or payload[k] is None:
            raise ValueError(f"payload needs {k!r}: {sorted(keys)}")
    return payload


def _v_prefill(payload: Any, engine: Any) -> Dict[str, Any]:
    p = _need(payload, "seq", "tokens")
    toks = np.asarray(p["tokens"], np.int64).ravel()
    if toks.size == 0:
        raise ValueError("prefill 'tokens' must be non-empty")
    out = {"seq": p["seq"], "tokens": toks.astype(np.int32)}
    if p.get("reserve") is not None:
        out["reserve"] = int(p["reserve"])
    return out


def _v_decode(payload: Any, engine: Any) -> Dict[str, Any]:
    p = _need(payload, "seq")
    tok = p.get("token")
    return {"seq": p["seq"],
            "token": None if tok is None else int(tok)}


def _v_release(payload: Any, engine: Any) -> Dict[str, Any]:
    return {"seq": _need(payload, "seq")["seq"]}


def _one_row(payload: Dict[str, Any]) -> int:
    return 1


class DecodeAdapter(ArtifactAdapter):
    """LM decode over :class:`DecodeArtifact` feats.

    ``run_group`` walks the coalesced batch in arrival order and folds
    consecutive ``decode`` requests into ONE ``step_sequences`` call (one
    launch per capacity group).  A prefill, a release, or a second request
    for the same sequence flushes the run (a sequence advances one position
    per launch)."""

    kinds = {
        "prefill": RequestKind(
            "prefill", _v_prefill, _one_row,
            doc="{'seq', 'tokens', 'reserve'?} -> PrefillResult"),
        "decode": RequestKind(
            "decode", _v_decode, _one_row,
            doc="{'seq', 'token'?} -> DecodeResult (token=None: greedy)"),
        "release": RequestKind(
            "release", _v_release, _one_row,
            doc="{'seq'} -> final position; frees KV state"),
    }

    def warmup(self, art: Any, buckets, *, img: int = 32, cache=None,
               metrics=None) -> None:
        art.feats.warmup(buckets, img=img, cache=cache, metrics=metrics,
                         label=art.name)

    def run_group(self, engine: Any, pairs: List[Tuple[Any, Any]]) -> None:
        run: List[Tuple[Any, Any]] = []          # consecutive decode reqs
        run_seqs: set = set()

        def flush() -> None:
            if not run:
                return
            art0 = run[0][0]
            da: DecodeArtifact = art0.feats
            t_x0 = time.perf_counter()
            try:
                results, stats = da.step_sequences(
                    [(r.payload["seq"], r.payload["token"])
                     for _, r in run])
            except Exception as exc:              # noqa: BLE001
                for _, r in run:
                    engine._fail(r, exc)
                run.clear()
                run_seqs.clear()
                return
            t_x1 = time.perf_counter()
            for n_real, bucket in stats:
                engine.metrics.record_batch(n_real, bucket)
            self._spans(engine, run, t_x0, t_x1, stats)
            for (art, r), (seq, tok, pos, logits) in zip(run, results):
                r.t_exec1 = t_x1
                engine._fulfill(r, DecodeResult(seq, tok, pos, logits,
                                                art.name))
            run.clear()
            run_seqs.clear()

        for art, r in pairs:
            if r.kind == "decode":
                seq = r.payload["seq"]
                if not art.feats.has(seq):
                    engine._fail(r, KeyError(f"unknown sequence {seq!r}"))
                    continue
                if seq in run_seqs or (run and run[0][0].feats
                                       is not art.feats):
                    flush()
                run.append((art, r))
                run_seqs.add(seq)
                continue
            flush()
            t_x0 = time.perf_counter()
            try:
                if r.kind == "prefill":
                    tok, pos, logits = art.feats.start_sequence(
                        r.payload["seq"], r.payload["tokens"],
                        reserve=r.payload.get("reserve"))
                    value: Any = PrefillResult(r.payload["seq"], tok, pos,
                                               logits, art.name)
                    engine.metrics.record_batch(1, 1)
                else:                             # release
                    value = art.feats.release(r.payload["seq"])
            except Exception as exc:              # noqa: BLE001
                engine._fail(r, exc)
                continue
            t_x1 = time.perf_counter()
            self._spans(engine, [(art, r)], t_x0, t_x1, None)
            r.t_exec1 = t_x1
            engine._fulfill(r, value)
        flush()

    @staticmethod
    def _spans(engine: Any, run: List[Tuple[Any, Any]], t_x0: float,
               t_x1: float, stats) -> None:
        """queue/coalesce/exec children per request: the span shape the FSL
        adapter emits, so decode traffic reads the same in a trace."""
        tr = engine.tracer
        if not tr.enabled:
            return
        evs = []
        for art, r in run:
            root = r.trace + "-00"
            evs.append(("serve.queue", r.t_enq, r.t_deq, r.trace,
                        root, None, None, None))
            evs.append(("serve.coalesce", r.t_deq, t_x0, r.trace,
                        root, None, None, None))
            evs.append(("serve.exec", t_x0, t_x1, r.trace, root, None, None,
                        {"artifact": art.name, "kind": r.kind,
                         "tenant": r.tenant,
                         "launches": len(stats) if stats else 1}))
        tr.record_many(evs)


# -- the client loop and the artifact factory --------------------------------

_GEN_IDS = itertools.count()


def greedy_generate(engine: Any, prompts: Sequence[Sequence[int]],
                    max_new: int, *, artifact: Optional[str] = None,
                    timeout: float = 120.0) -> List[List[int]]:
    """Greedy-decode ``max_new`` tokens for each prompt through the engine
    (prefill once, then lockstep decode rounds — concurrent submits per
    round, so the adapter coalesces each round into one launch)."""
    seqs = [f"gen-{next(_GEN_IDS)}" for _ in prompts]
    futs = [engine.submit("prefill", {"seq": s, "tokens": list(p)},
                          artifact=artifact)
            for s, p in zip(seqs, prompts)]
    out = [[f.result(timeout).token] for f in futs]
    for _ in range(int(max_new) - 1):
        futs = [engine.submit("decode", {"seq": s}, artifact=artifact)
                for s in seqs]
        for toks, f in zip(out, futs):
            toks.append(f.result(timeout).token)
    for s in seqs:
        engine.submit("release", {"seq": s}, artifact=artifact)
    return out


def build_decode_artifact(params: Any, cfg: Any, *, datapath: str = "int",
                          capacities: Sequence[int] = (32, 64),
                          fuse: bool = True, verify: bool = True,
                          with_prefill: bool = False,
                          device: DeviceLike = None) -> DecodeArtifact:
    """Compile ``(params, cfg)`` through the ``lm-decode`` recipe into a
    servable :class:`DecodeArtifact` on ``device`` (default: the card,
    which raises without one).  With ``verify`` every pass is checked
    against the interpreter on example feeds, bit for bit (``rtol`` and
    ``atol`` 0): the graph's matmuls multiply grid values exactly and the
    float ops between quantizers are the same calls before and after
    lowering."""
    from repro_torch.core import deploy
    from repro_torch.device import resolve_device
    from repro_torch.models import lm       # registers the lm-decode recipe

    dev = resolve_device(device)
    caps = normalize_buckets(capacities)
    feeds = lm.example_decode_feeds(cfg, batch=2, capacity=int(caps[0]))
    dm = deploy.compile({"params": params, "cfg": cfg}, cfg.quant,
                        recipe="lm-decode", datapath=datapath, fuse=fuse,
                        verify_feeds=feeds if verify else None, device=dev,
                        rtol=0.0, atol=0.0)
    dmp = None
    if with_prefill:
        gp = lm.export_prefill_graph(params, cfg)
        pf = lm.example_prefill_feeds(cfg) if verify else None
        dmp = deploy.compile(gp, cfg.quant, recipe="lm-decode",
                             datapath=datapath, fuse=fuse, verify_feeds=pf,
                             device=dev, rtol=0.0, atol=0.0)
    return DecodeArtifact(dm, cfg.d_model, capacities=caps, vocab=cfg.vocab,
                          dm_prefill=dmp)
