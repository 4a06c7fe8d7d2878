"""The MVAU kernels' share of their roofline in the traced stretch, in %:
the least time the card could take for the MVAU launches the trace holds,
over their device time (every kernel whose name holds ``mvau_``).

A call's least time is :func:`portbench.counts.mvau_bound_s` (per MVAU the
larger of operations over the int8 peak and bytes over HBM's). A launch's
share of it is that over the call's launches (the port's launch counter
over the stretch's calls), so a launch the tracer lost drops from both
sides; with none lost it is the call's bound times the calls over the
MVAU kernels' time."""

from portbench import counts


def read(r):
    tr = getattr(r, "trace", None)
    if tr is None or not tr.calls or not getattr(tr, "mvau_launches", 0):
        return None
    seen = [(c, t) for name, (c, t) in tr.by_name().items() if "mvau_" in name]
    n_seen, t_seen = sum(c for c, _ in seen), sum(t for _, t in seen)
    if not n_seen or t_seen <= 0:
        return None
    per_launch = counts.mvau_bound_s(r.cfg, r.batch) * tr.calls / \
        tr.mvau_launches
    return per_launch * n_seen / t_seen * 100.0
