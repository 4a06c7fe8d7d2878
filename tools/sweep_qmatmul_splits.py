#!/usr/bin/env python3
"""Time the qmatmul kernel at Qwen2.5-3B's decode shapes for every K split.

Run from the repository root on a machine with one CUDA card::

    python3 tools/sweep_qmatmul_splits.py

For each projection shape (K, N) at batch 4 in bf16, w8 and w4, it launches
the kernel on 36 distinct weight matrices in turn (as one decode step
streams the layers, so nothing sits in the 50 MB L2) with K split 1, 2,
4, ... ways, and prints microseconds per launch beside the bytes bound and
the split that ``repro_torch.kernels.qmatmul.split_plan`` picks.  This is
the measurement behind that rule.
"""

from __future__ import annotations

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

LAYERS, BATCH, REPS = 36, 4, 3
SHAPES = ((2048, 2048), (2048, 256), (2048, 11008), (11008, 2048))


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        sys.stderr.write("needs a CUDA device\n")
        return 2
    from repro_torch.device import resolve_device
    from repro_torch.kernels import build as B
    from repro_torch.kernels import qmatmul as KQ

    resolve_device(None)
    lib = B.library()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    stream = torch.cuda.current_stream().cuda_stream
    for bits in (8, 4):
        for k, n in SHAPES:
            ws = [torch.randint(-128, 128, (k, n if bits == 8 else n // 2),
                                dtype=torch.int8, device="cuda")
                  for _ in range(LAYERS)]
            s = torch.rand(n, device="cuda")
            x = torch.rand(BATCH, k, device="cuda").to(torch.bfloat16)
            out = torch.empty(BATCH, n, device="cuda", dtype=torch.bfloat16)
            partial = torch.empty(64, BATCH, n, device="cuda")
            mt = KQ.split_plan(BATCH, k, n, sms)[0]
            row = []
            for splits in (1, 2, 4, 8, 16, 32):
                if k // splits < 64:
                    continue

                def one(w, splits=splits):
                    rc = lib.qmatmul(x.data_ptr(), 1, w.data_ptr(), bits,
                                     s.data_ptr(), out.data_ptr(),
                                     partial.data_ptr(), BATCH, k, n, mt,
                                     splits, -(-k // splits), stream)
                    B.check(rc, "qmatmul")

                for w in ws:
                    one(w)
                torch.cuda.synchronize()
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                torch.cuda._sleep(200_000_000)    # host enqueues ahead
                start.record()
                for _ in range(REPS):
                    for w in ws:
                        one(w)
                end.record()
                end.synchronize()
                us = start.elapsed_time(end) / (REPS * LAYERS) * 1e3
                row.append(f"s{splits}:{us:.1f}")
            bound_us = ws[0].numel() / 3.35e12 * 1e6
            sys.stdout.write(
                f"w{bits} K={k} N={n}: bound {bound_us:.2f} us, split_plan "
                f"s{KQ.split_plan(BATCH, k, n, sms)[1]}; us/launch "
                + " ".join(row) + "\n")
            del ws
    return 0


if __name__ == "__main__":
    sys.exit(main())
