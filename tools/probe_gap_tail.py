#!/usr/bin/env python3
"""Where the time of the fused GlobalAccPool tail goes on the card.

Run from the repository root on a machine with one NVIDIA H100::

    PYTHONPATH=src python3 tools/probe_gap_tail.py

At r2b's shape of the w6a4 ResNet-9 at batch 64 (int8 4x4x512 codes, K
4608, N 512, an int32 skip of the conv output's shape) it times, by CUDA
events around each call, three forms of the tail: the conv MVAU with its
GAP epilogue (``fused``), the conv alone (``conv``), and the unfused chain
(conv, torch add, GAP kernel: ``chain``).  Each form runs ``hot`` (nothing
between calls) and ``flushed`` (a 256 MB buffer written between calls,
outside the events, which evicts the kernels' code and data from the 50 MB
L2).

Then the width-64 w6a4 int artifact's forward at batch 64 is timed the
same way, whole, lowered with the tail fused and unfused
(``lower_graph(..., fold_pools=False)``), and the kernel timeline of one
forward of each is printed: each kernel's start, duration and the idle gap
before it.  All launches are queued behind a device-side sleep, so no host
gap falls inside a timed call.  Prints one line per number and, last, all
of them as one JSON object.
"""

from __future__ import annotations

import dataclasses
import json
import statistics
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "src"))

SLEEP_CYCLES = 400_000_000          # about 0.2 s of device clock
REPS = 50


def timed(torch, fn, prep=None, reps=REPS):
    """Median device ms of ``fn`` over ``reps`` calls, each after ``prep``
    (outside the events), and the (min, max) of the calls."""
    fn()
    torch.cuda.synchronize()
    ev = [(torch.cuda.Event(enable_timing=True),
           torch.cuda.Event(enable_timing=True)) for _ in range(reps)]
    torch.cuda._sleep(SLEEP_CYCLES)
    for start, end in ev:
        if prep is not None:
            prep()
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    ms = [s.elapsed_time(e) for s, e in ev]
    return statistics.median(ms), (min(ms), max(ms))


def timeline(torch, fn, label, calls=3):
    """Device timeline of the last of ``calls`` forwards queued behind a
    sleep: each kernel's start (µs after the first), duration and the idle
    gap before it."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.cuda._sleep(SLEEP_CYCLES // 10)
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    kern = sorted((e for e in prof.events()
                   if e.device_type == DeviceType.CUDA
                   and "sleep" not in e.name),
                  key=lambda e: e.time_range.start)
    last = kern[-(len(kern) // calls):]
    t0 = last[0].time_range.start
    rows, prev = [], None
    for e in last:
        gap = 0.0 if prev is None else e.time_range.start - prev
        rows.append((e.name[:60], e.time_range.start - t0,
                     e.time_range.elapsed_us(), gap))
        prev = e.time_range.end
    print(f"timeline {label} forward (kernel, start us, duration us, gap "
          f"before us): {len(last)} kernels, span "
          f"{last[-1].time_range.end - t0:.1f} us, idle "
          f"{sum(r[3] for r in rows):.1f} us")
    for name, start, dur, gap in rows:
        print(f"  {start:8.1f} {dur:7.1f} {gap:6.1f}  {name}")
    return rows


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        sys.stderr.write("probe_gap_tail: needs a CUDA device\n")
        return 2
    import repro_torch
    from repro_torch.core.deploy import lower_graph
    from repro_torch.core.quant import QuantConfig
    from repro_torch.kernels import gap as KG
    from repro_torch.kernels import mvau as KM
    from repro_torch.models import resnet9

    dev = "cuda"
    gen = torch.Generator().manual_seed(7)
    b, c, n = 64, 512, 512
    x = torch.randint(0, 16, (b, 4, 4, c), generator=gen).to(torch.int8).to(dev)
    w = torch.randint(-32, 32, (9 * c, n), generator=gen).to(torch.int8).to(dev)
    t = torch.sort(torch.randint(-2000, 2000, (n, 15), generator=gen),
                   dim=1).values.to(torch.int32).to(dev)
    skip = torch.randint(0, 16, (b, 4, 4, n), generator=gen
                         ).to(torch.int32).to(dev)
    forms = {
        "fused": lambda: KM.mvau_int_conv_gap(x, w, t, skip, 3, 1, 1),
        "conv": lambda: KM.mvau_int_conv(x, w, t, 3, 1, 1),
        "chain": lambda: KG.gap(KM.mvau_int_conv(x, w, t, 3, 1, 1) + skip),
    }
    assert torch.equal(forms["fused"](), forms["chain"]())
    flush_buf = torch.empty(64 * 2**20, dtype=torch.int32, device=dev)
    states = {"hot": None, "flushed": lambda: flush_buf.fill_(1)}
    out = {"shape": "r2b, batch 64: (64, 4, 4, 512) int8 x (4608, 512) int8, "
                    "int32 skip", "card": torch.cuda.get_device_name(0)}
    for state, prep in states.items():
        row = {}
        for k, fn in forms.items():
            row[k], row[f"{k}_min_max"] = timed(torch, fn, prep)
        out[state] = row
        print(f"tail {state:7s}: fused {row['fused']:.4f} ms, conv alone "
              f"{row['conv']:.4f}, chain {row['chain']:.4f}; min/max "
              + ", ".join(f"{k} {row[f'{k}_min_max'][0]:.4f}/"
                          f"{row[f'{k}_min_max'][1]:.4f}" for k in forms),
              flush=True)

    params = resnet9.init_params(torch.Generator().manual_seed(0), 64,
                                 device=dev)
    dm = repro_torch.compile(params, QuantConfig.paper_w6a4(),
                             recipe="resnet9", datapath="int")
    unfused = dataclasses.replace(
        dm, apply=lower_graph(dm.graph, dev, fold_pools=False))
    frames = torch.rand((b, 32, 32, 3), generator=gen).to(dev)
    assert torch.equal(dm(frames), unfused(frames))
    fwd = {}
    for label, fn in (("fused", lambda: dm(frames)),
                      ("unfused", lambda: unfused(frames)),
                      ("fused again", lambda: dm(frames)),
                      ("unfused again", lambda: unfused(frames))):
        fwd[label] = timed(torch, fn, reps=20)[0]
        print(f"int forward, batch 64, device time with no host gaps, "
              f"{label}: {fwd[label]:.4f} ms", flush=True)
    out["forward_ms"] = fwd
    for label, fn in (("fused", lambda: dm(frames)),
                      ("unfused", lambda: unfused(frames))):
        out[f"timeline_{label}"] = timeline(torch, fn, label)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
