#!/usr/bin/env python3
"""The port's benchmark: one run of one cell, on the card.

    python3 portbench/run.py --workload w6a4-offline --seed 7 --seconds 10 --trace 0

Run from the root of a checkout. The cells are in ``BENCHMARK.json``; the
last line of standard output is the result as one JSON object, and the
last lines of standard error are the numbers compared with the reference,
each beside its limit. Without a CUDA device, or with fewer than the cell
needs, it prints no result and exits with 3; with JAX or the JAX package
loaded after the window, with 4.

Build and kernel caches stay inside the checkout, at fixed paths: the
port's CUDA library in ``src/repro_torch/_build/`` (the port's own rule),
PyTorch's and Triton's under ``portbench/out/cache/``. Outputs (span
exports) go to ``portbench/out/``.
"""

import os
import sys
import time

_T0 = time.perf_counter()


def _age_at_start() -> float:
    """Seconds since this process was created, from ``/proc`` (10 ms
    ticks); 0 where that cannot be read."""
    try:
        with open("/proc/self/stat") as fh:
            start_ticks = int(fh.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as fh:
            uptime = float(fh.read().split()[0])
        return max(uptime - start_ticks / os.sysconf("SC_CLK_TCK"), 0.0)
    except (OSError, ValueError, IndexError):
        return 0.0


_AGE0 = _age_at_start()
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_CACHE = os.path.join(ROOT, "portbench", "out", "cache")
os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(_CACHE, "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = os.path.join(_CACHE, "triton")
sys.path[:0] = [os.path.join(ROOT, "src"), ROOT]


def age() -> float:
    return _AGE0 + time.perf_counter() - _T0


if __name__ == "__main__":
    from portbench import harness

    sys.exit(harness.main(sys.argv[1:], age))
