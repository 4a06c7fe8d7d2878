"""The whole ensemble's share of the H100's dense int8 peak while the card
works, in %: the operations of the traced stretch's calls (2*M*K*N of
every MVAU, twice for the flip, from the configuration's shapes) over the
time in which anything ran on the card (the union of the trace's kernel
and copy intervals), over 1,979 TOP/s. Host time and idle gaps are left
out, so it separates the card's pace from the host's."""

from portbench import counts


def read(r):
    tr = getattr(r, "trace", None)
    if tr is None or not tr.device or not tr.calls:
        return None
    busy = tr.busy_s()
    if busy <= 0:
        return None
    ops = counts.ops_per_frame(r.cfg) * r.batch * tr.calls
    return ops / busy / counts.PEAK_INT8_OPS * 100.0
