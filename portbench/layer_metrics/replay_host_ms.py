"""Host time per call of the deployed ensemble's feature function in the
window, in ms: copy in, graph replay and clone out enqueued, summed over
the calls and divided by their number (the benchmark's own spans)."""


def read(r):
    host = getattr(r, "host_call_s", None)
    return None if not host else sum(host) / len(host) * 1e3
