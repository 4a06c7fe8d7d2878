"""Offline featurisation: batches of frames already on the card, through
the system's feature function, ``ahead`` calls in flight; the rate of
frames over the whole window.

A traffic file names its driver, ``portbench/drivers/<driver>.py``, and
gives its parameters. A driver module has a ``Driver`` class, which builds
the system in its constructor (set-up), runs the window, runs a traced
stretch of the same traffic on request, then hands over the answers the
window produced for the comparison with the reference; and a function
``control_numbers``, which judges the control's answers in the program's
place by the same numbers.
"""

from __future__ import annotations

import gc
import sys
import time
from typing import Any, Callable, Dict, List, Optional

import torch

from portbench import check, frames as F
from portbench.trace import traced


def _frames(ctx, n: int):
    rng = ctx.rng("frames")
    d = ctx.cfg["data"]
    gen = F.Frames(rng, d["classes"], ctx.cfg["img"], d["signal"], d["noise"])
    return F.labelled(rng, gen, n)


def inputs(ctx) -> List[torch.Tensor]:
    """The resident batches, on the device."""
    b = int(ctx.traffic["batch"])
    x, _ = _frames(ctx, b * int(ctx.traffic["resident_batches"]))
    return list(torch.from_numpy(x).to(ctx.dev.device).split(b))


class Driver:
    """Set-up: the weights, ``resident_batches`` batches of frames on the
    device, the deployed ensemble warmed at the one batch size used."""

    def __init__(self, ctx):
        self.ctx = ctx
        tr, cfg = ctx.traffic, ctx.cfg
        self.batch = int(tr["batch"])
        self.xs = inputs(ctx)
        self.feats = ctx.system.deploy(cfg, ctx.params, ctx.dev.device)
        self.feats.warmup([self.batch], img=cfg["img"])
        self.kept: Dict[int, torch.Tensor] = {}
        self.e2e: Dict[str, float] = {}
        self.readings: Dict[str, Any] = {}

    def _issue(self, n: Optional[int], seconds: Optional[float],
               keep_at: Optional[List[float]] = None,
               host: Optional[list] = None):
        """Calls of the feature function on the resident batches in turn,
        never more than ``ahead`` unfinished: ``n`` of them, or as many as
        start within ``seconds``. With ``keep_at`` the output of the first
        call at or after each of those times, and of the last call, is
        kept for the comparison. Returns (calls, seconds to the last one's
        end)."""
        ahead = int(self.ctx.traffic["ahead"])
        ring: List[Any] = [None] * ahead
        dev, feats, xs = self.ctx.dev, self.feats, self.xs
        marks = list(keep_at or ())
        i, last = 0, None
        t0 = time.perf_counter()
        while n is None or i < n:
            ev = ring[i % ahead]
            if ev is not None:
                ev.synchronize()
            now = time.perf_counter() - t0
            if seconds is not None and now >= seconds:
                break
            h0 = time.perf_counter()
            out = feats(xs[i % len(xs)])
            if host is not None:
                host.append(time.perf_counter() - h0)
            ring[i % ahead] = dev.record()
            if marks and now >= marks[0]:
                self.kept[i] = out
                while marks and now >= marks[0]:
                    marks.pop(0)
            last = (i, out)
            i += 1
        dev.sync()
        elapsed = time.perf_counter() - t0
        if last is not None and keep_at is not None:
            self.kept[last[0]] = last[1]
        return i, elapsed

    def window(self, seconds: float) -> float:
        """The measured window; returns its start on the host clock."""
        n_keep = int(self.ctx.traffic["checked_calls"])
        marks = sorted(self.ctx.rng("sample").random(n_keep) * seconds)
        host: List[float] = []
        t_start = time.perf_counter()
        calls, elapsed = self._issue(None, seconds, marks, host)
        self.calls = calls
        self.e2e["images_per_s"] = calls * self.batch / elapsed
        self.readings.update(window_s=elapsed, calls=calls,
                             host_call_s=host, batch=self.batch)
        return t_start

    def traced_stretch(self):
        """``trace_calls`` calls under the profiler, read again (up to
        ``trace_reads`` times) while it loses events: every call launches
        the same kernels, so a kernel counted other than a multiple of the
        calls was lost. The last read is kept either way, with the MVAU
        launches the port's own counter saw in it."""
        n = int(self.ctx.traffic["trace_calls"])
        ahead = int(self.ctx.traffic["ahead"])
        launches = self.ctx.system.mvau_launches
        counted = {}

        def stretch() -> int:
            before = launches()
            calls = self._issue(n, None)[0]
            counted["mvau"] = launches() - before
            return calls

        for _ in range(int(self.ctx.traffic["trace_reads"])):
            tr = traced(lambda: self._issue(ahead, None), stretch,
                        self.ctx.dev.on_card)
            tr.mvau_launches = counted["mvau"]
            torn = {k: c for k, (c, _) in tr.by_name().items() if c % n}
            if not torn:
                break
            print(f"traced stretch lost events: {len(torn)} kernels with "
                  f"counts not a multiple of {n}, e.g. "
                  f"{next(iter(torn.items()))}", file=sys.stderr)
        return tr

    def free(self) -> None:
        self.feats = None
        gc.collect()

    def compare(self, reference) -> List[check.Number]:
        """Every kept call's features against the reference's for its
        batch, exactly."""
        ref = {}
        for i in self.kept:
            b = i % len(self.xs)
            if b not in ref:
                ref[b] = reference(self.xs[b])
        return [check.feature_mismatch(
            self.kept, {i: ref[i % len(self.xs)] for i in self.kept},
            self.ctx.traffic["limits"])]

    @property
    def attempted(self) -> int:
        return self.calls


def control_numbers(ctx, feats: Callable) -> List[check.Number]:
    """The numbers of the cell's comparison with the control's features in
    the program's place: ``feats(x, grid)`` is the reference on ``grid``;
    every resident batch is judged."""
    cfg = ctx.cfg
    low = dict(cfg, **cfg["control"])
    xs = inputs(ctx)
    got = {i: feats(x, low).to(torch.float32) for i, x in enumerate(xs)}
    want = {i: feats(x, cfg) for i, x in enumerate(xs)}
    return [check.feature_mismatch(got, want, ctx.traffic["limits"])]
