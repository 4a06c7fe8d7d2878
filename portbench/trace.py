"""Device traces: ``torch.profiler`` over a stretch of traffic, reduced to
intervals.

A traced stretch runs in two profiler steps: a warm-up step whose events
are dropped (started cold, the tracer has lost the first kernels of a run),
then the step that is read. What is read is the device's kernels and copies
and the host's operations, each as ``(name, start_us, end_us)``; the
readers of the per-layer metrics and the breakdown work from those lists.
"""

from __future__ import annotations

import dataclasses
import time
from collections import defaultdict
from typing import Callable, Dict, List, Optional, Tuple

from portbench import counts

Interval = Tuple[str, float, float]


@dataclasses.dataclass
class Trace:
    device: List[Interval]          # kernels, copies and sets on the card
    host: List[Interval]            # host operations (all threads)
    window_s: float                 # host wall time of the traced stretch
    calls: int                      # calls or requests the stretch made

    def busy_s(self) -> float:
        return counts.union_seconds((s, e) for _, s, e in self.device) / 1e6

    def by_name(self) -> Dict[str, Tuple[int, float]]:
        """kernel name -> (launches, seconds)."""
        out: Dict[str, List] = defaultdict(lambda: [0, 0.0])
        for name, s, e in self.device:
            out[name][0] += 1
            out[name][1] += (e - s) / 1e6
        return {k: (n, t) for k, (n, t) in out.items()}

    def breakdown(self, top: int = 10) -> Dict[str, List]:
        """The ``top`` device operations by time, and the ``top`` longest
        idle gaps of the device, each named by what the host was doing
        then: the host operation that overlaps it most (the shortest such
        one on a tie)."""
        ops = sorted(self.by_name().items(), key=lambda kv: -kv[1][1])
        out = {"device_ops": [[name, t] for name, (_, t) in ops[:top]],
               "idle_gaps": []}
        if not self.device:
            return out
        lo = min(s for _, s, _ in self.device)
        hi = max(e for _, _, e in self.device)
        longest = sorted(counts.gaps(((s, e) for _, s, e in self.device),
                                     lo, hi), key=lambda g: g[0] - g[1])[:top]
        for gs, ge in longest:
            best, best_key = "host: nothing traced", None
            for name, s, e in self.host:
                ov = min(e, ge) - max(s, gs)
                if ov > 0 and (best_key is None
                               or (ov, s - e) > best_key):
                    best, best_key = name, (ov, s - e)
            out["idle_gaps"].append([best, (ge - gs) / 1e6])
        return out


def traced(warm: Callable[[], None], stretch: Callable[[], int],
           on_card: bool) -> Trace:
    """Run ``warm`` (events dropped), then ``stretch`` (read), under the
    profiler. ``stretch`` returns the calls it made and ends with the
    device idle. Off the card the profiler reads the host alone."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if on_card
                                     else [])
    with profile(activities=acts,
                 schedule=schedule(wait=0, warmup=1, active=1,
                                   repeat=1)) as prof:
        warm()
        prof.step()
        t0 = time.perf_counter()
        calls = stretch()
        window_s = time.perf_counter() - t0
        prof.step()
    device, host = [], []
    for ev in prof.events():
        if ev.name.startswith("ProfilerStep"):     # the profiler's own marks
            continue
        iv = (ev.name, float(ev.time_range.start), float(ev.time_range.end))
        (device if ev.device_type == DeviceType.CUDA else host).append(iv)
    return Trace(device, host, window_s, calls)


def idle_share(tr) -> Optional[float]:
    """Percent of a trace's window with nothing running on the device;
    None without device events to read."""
    if tr is None or not tr.device or tr.window_s <= 0:
        return None
    return (1.0 - tr.busy_s() / tr.window_s) * 100.0
