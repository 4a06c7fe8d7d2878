"""Straggler detection for synchronous data-parallel training: the port's
copy of the JAX package's ``dist/straggler.py`` (plain Python), with the
same verdicts and the same ``events`` strings.

Synchronous steps run at the speed of the slowest worker, so a
persistently slow host taxes the whole job.  The monitor keeps a rolling
window of recent step durations and compares each new observation against a
robust baseline (median): a step far above baseline is a ``"warn"``; after
``sustain`` consecutive warns the verdict escalates to ``"evict"`` — the
launcher's cue to checkpoint, cordon the host and restart.  Transient noise
(GC pauses, one slow batch) never reaches eviction because the counter
resets on any normal step.
"""

from __future__ import annotations

import collections
import statistics
from typing import Deque, List, Optional


class StragglerMonitor:
    """Observe (step, duration) pairs; return None | "warn" | "evict"."""

    def __init__(self, window: int = 50, factor: float = 1.5,
                 min_history: int = 5, sustain: int = 3):
        self.window: Deque[float] = collections.deque(maxlen=window)
        self.factor = factor
        self.min_history = min_history
        self.sustain = sustain
        self.slow_streak = 0
        self.events: List[str] = []

    def baseline(self) -> Optional[float]:
        if len(self.window) < self.min_history:
            return None
        return statistics.median(self.window)

    def observe(self, step: int, duration_s: float) -> Optional[str]:
        base = self.baseline()
        self.window.append(float(duration_s))
        if base is None or duration_s <= self.factor * base:
            self.slow_streak = 0
            return None
        self.slow_streak += 1
        if self.slow_streak >= self.sustain:
            self.slow_streak = 0
            self.events.append(
                f"evict step={step} dur={duration_s:.3f}s base={base:.3f}s")
            return "evict"
        self.events.append(
            f"warn step={step} dur={duration_s:.3f}s base={base:.3f}s")
        return "warn"
