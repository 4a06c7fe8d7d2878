"""Render a JSONL trace file into stage breakdowns.

  python -m repro_torch.obs.summarize trace.jsonl [--trace req-...] [--trees N]

The port's copy of the JAX package's ``obs/summarize.py`` (pure Python),
over the port's :func:`repro_torch.obs.export.read_jsonl`.

Three views over the span events the serving/compile spine emits:

* **stage breakdown** — per span name: count, total/mean/p50/p95 duration
  and share of summed span time.  ``serve.queue`` vs ``serve.exec`` is the
  queue-wait-vs-work split; ``cluster.route`` shows routing overhead.
* **padding overhead** — from ``serve.batch`` spans: real vs padded rows
  per bucket, the wasted fraction bucketing costs.
* **trace trees** (``--trees N`` / ``--trace ID``) — parent-nested span
  listings for the slowest N request traces, the single-request debugging
  view.

All output goes through ``sys.stdout.write`` (bare ``print`` is banned
under ``repro_torch.obs``/``repro_torch.serve`` — runtime output belongs
to exporters).
"""

from __future__ import annotations

import argparse
import sys
from collections import defaultdict
from typing import Any, Dict, List, Sequence

from repro_torch.obs.export import read_jsonl

__all__ = ["render", "render_tree", "stage_stats"]


def _pct(sorted_vals: Sequence[float], p: float) -> float:
    if not sorted_vals:
        return float("nan")
    k = max(0, min(len(sorted_vals) - 1,
                   int(round(p / 100.0 * (len(sorted_vals) - 1)))))
    return float(sorted_vals[k])


def stage_stats(events: Sequence[Dict[str, Any]]) -> Dict[str, Dict[str, float]]:
    """Per span-name duration statistics over a list of trace events."""
    by_name: Dict[str, List[float]] = defaultdict(list)
    for e in events:
        by_name[e.get("name", "?")].append(float(e.get("dur_ms", 0.0)))
    grand = sum(sum(v) for v in by_name.values()) or 1.0
    out = {}
    for name, durs in sorted(by_name.items()):
        durs.sort()
        total = sum(durs)
        out[name] = {
            "count": len(durs), "total_ms": total,
            "mean_ms": total / len(durs),
            "p50_ms": _pct(durs, 50), "p95_ms": _pct(durs, 95),
            "share": total / grand,
        }
    return out


def _padding(events: Sequence[Dict[str, Any]]) -> Dict[str, float]:
    real = padded = batches = 0
    for e in events:
        if e.get("name") != "serve.batch":
            continue
        a = e.get("attrs", {})
        real += int(a.get("n_real", 0))
        padded += int(a.get("padded", 0))
        batches += 1
    return {"batches": batches, "real": real, "padded": padded,
            "padded_frac": padded / max(real + padded, 1)}


def render_tree(events: Sequence[Dict[str, Any]], trace: str) -> str:
    """One trace's spans as a parent-nested tree, children in start order."""
    spans = [e for e in events if e.get("trace") == trace]
    if not spans:
        return f"trace {trace}: no spans"
    by_parent: Dict[Any, List[Dict]] = defaultdict(list)
    ids = {e["span"] for e in spans}
    for e in spans:
        p = e.get("parent")
        by_parent[p if p in ids else None].append(e)
    for kids in by_parent.values():
        kids.sort(key=lambda e: e.get("t0", 0.0))
    lines = [f"trace {trace} ({len(spans)} spans)"]

    def walk(parent, depth):
        for e in by_parent.get(parent, ()):
            status = e.get("status", "ok")
            attrs = e.get("attrs") or {}
            extra = "".join(f" {k}={attrs[k]}" for k in
                            ("tenant", "kind", "artifact", "bucket",
                             "replica", "pass") if attrs.get(k) is not None)
            lines.append(f"  {'  ' * depth}{e['name']:18s} "
                         f"{e.get('dur_ms', 0.0):9.3f} ms  [{status}]{extra}")
            if e["span"] in ids:
                walk(e["span"], depth + 1)

    walk(None, 0)
    return "\n".join(lines)


def render(events: Sequence[Dict[str, Any]], trees: int = 0) -> str:
    """The full summary: stage table + padding overhead (+ slowest trees)."""
    if not events:
        return "no events"
    lines = [f"{len(events)} spans, "
             f"{len({e.get('trace') for e in events})} traces"]
    lines.append(f"{'stage':20s} {'count':>7s} {'total ms':>10s} "
                 f"{'mean ms':>9s} {'p50 ms':>9s} {'p95 ms':>9s} {'share':>7s}")
    for name, s in stage_stats(events).items():
        lines.append(f"{name:20s} {s['count']:7d} {s['total_ms']:10.2f} "
                     f"{s['mean_ms']:9.3f} {s['p50_ms']:9.3f} "
                     f"{s['p95_ms']:9.3f} {s['share']:6.1%}")
    pad = _padding(events)
    if pad["batches"]:
        lines.append(
            f"padding: {pad['batches']} batches, {pad['real']} real + "
            f"{pad['padded']} padded rows ({pad['padded_frac']:.1%} waste)")
    err = sum(1 for e in events
              if str(e.get("status", "ok")).startswith(("error", "rejected")))
    if err:
        lines.append(f"non-ok spans: {err}")
    if trees:
        roots = [e for e in events if e.get("name") == "serve.request"]
        roots.sort(key=lambda e: -float(e.get("dur_ms", 0.0)))
        for e in roots[:trees]:
            lines.append("")
            lines.append(render_tree(events, e["trace"]))
    return "\n".join(lines)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(
        description="summarize a repro_torch.obs JSONL trace file")
    ap.add_argument("path", help="JSONL trace file (JsonlExporter output)")
    ap.add_argument("--trace", default="",
                    help="render one trace ID as a span tree")
    ap.add_argument("--trees", type=int, default=0,
                    help="also render the N slowest request traces as trees")
    args = ap.parse_args(argv)
    events = read_jsonl(args.path)
    if args.trace:
        sys.stdout.write(render_tree(events, args.trace) + "\n")
        return
    sys.stdout.write(render(events, trees=args.trees) + "\n")


if __name__ == "__main__":
    main()
