"""Per-device cost attribution of a sharded step from a recorded dispatch
log — the port's counterpart of the JAX package's ``obs/hlo.py``.

The reference parses the SPMD-partitioned HLO text of a compiled step and
totals dot FLOPs and collective payload bytes with trip counts.  The port
runs the step eagerly over DTensors (in the dry run, on meta local shards
of a ``"fake"`` process group), so there is no HLO text: :class:`DispatchRecord`
is a ``TorchDispatchMode`` that lets DTensor place each op and then sees
the ops it runs on each rank's LOCAL tensors, so every count here is per
device, as the reference's:

1. dot FLOPs: ``2·M·K·N`` (and batched / convolution forms) of every
   matmul-family aten op, from ``torch.utils.flop_counter``'s formulas on
   the local shapes (the quantized product on meta codes runs its plain
   version, whose GEMM is counted so);
2. collective payload bytes and counts of the reference's five kinds,
   mapped from the c10d ops (functional and eager): ``all-reduce``,
   ``all-gather``, ``reduce-scatter``, ``all-to-all`` and
   ``collective-permute`` (point-to-point sends), each the bytes of its
   result (of the sent tensor for a send).  DTensor's shard-to-shard
   redistribution (``shard_dim_alltoall``) is one ``all-to-all`` of its
   input's bytes, as the card runs it; on a CPU mesh DTensor falls back to
   an all-gather and a chunk there, which is not recorded.

The log is a list of :class:`Event`; a loop runs its ops once per
iteration, so the log's totals are already trip-count aware.  Elementwise
FLOPs are ignored, as in the reference.  ``analyze``, ``top_collectives``
and ``top_dots`` keep the reference's names and keys; they read the log,
not HLO text.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List

import torch
from torch.utils._python_dispatch import TorchDispatchMode

__all__ = ["DispatchRecord", "Event", "analyze", "top_collectives",
           "top_dots"]

_COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
                "collective-permute")

# c10d op (functional and eager forms) -> the reference's collective kind
_COLLECTIVE_OPS = {
    "_c10d_functional.all_reduce": "all-reduce",
    "_c10d_functional.all_reduce_": "all-reduce",
    "_c10d_functional.all_reduce_coalesced": "all-reduce",
    "c10d.allreduce_": "all-reduce",
    "_c10d_functional.all_gather_into_tensor": "all-gather",
    "_c10d_functional.all_gather_into_tensor_coalesced": "all-gather",
    "c10d._allgather_base_": "all-gather",
    "c10d.allgather_": "all-gather",
    "_c10d_functional.reduce_scatter_tensor": "reduce-scatter",
    "_c10d_functional.reduce_scatter_tensor_coalesced": "reduce-scatter",
    "c10d._reduce_scatter_base_": "reduce-scatter",
    "c10d.reduce_scatter_": "reduce-scatter",
    "_c10d_functional.all_to_all_single": "all-to-all",
    "c10d.alltoall_base_": "all-to-all",
    "c10d.alltoall_": "all-to-all",
    "c10d.send": "collective-permute",
}


@dataclasses.dataclass
class Event:
    """One recorded op: ``kind`` is ``"dot"`` or a collective kind;
    ``op`` the aten/c10d op (or kernel) name; ``sig`` its local shapes;
    ``value`` FLOPs for a dot, payload bytes for a collective."""

    kind: str
    op: str
    sig: str
    value: float


def _tensors(x) -> List[torch.Tensor]:
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, (list, tuple)):
        return [t for v in x for t in _tensors(v)]
    return []


def _nbytes(ts: List[torch.Tensor]) -> float:
    return float(sum(t.numel() * t.element_size() for t in ts))


def _sig(args) -> str:
    return ",".join("x".join(map(str, t.shape)) for t in _tensors(args))


class DispatchRecord(TorchDispatchMode):
    """Record every dot and collective run on local tensors while active
    (``with DispatchRecord() as rec: step(...)``; then ``rec.events``)."""

    def __init__(self):
        super().__init__()
        self.events: List[Event] = []
        self._inside = 0          # in a recorded all-to-all: record nothing

    def __enter__(self):
        from torch.distributed.tensor import placement_types as PT

        self._alltoall = PT.shard_dim_alltoall

        def alltoall(input, gather_dim, shard_dim, mesh, mesh_dim):
            self.events.append(Event("all-to-all",
                                     "_dtensor.shard_dim_alltoall",
                                     _sig(input), _nbytes([input])))
            self._inside += 1
            try:
                return self._alltoall(input, gather_dim, shard_dim, mesh,
                                      mesh_dim)
            finally:
                self._inside -= 1

        PT.shard_dim_alltoall = alltoall
        return super().__enter__()

    def __exit__(self, *exc):
        from torch.distributed.tensor import placement_types as PT

        PT.shard_dim_alltoall = self._alltoall
        return super().__exit__(*exc)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor

        # let DTensor place the op; its local ops come back through here
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if self._inside:
            return out
        from torch._subclasses.fake_tensor import FakeTensor

        if any(issubclass(t, FakeTensor) for t in types):
            return out     # DTensor inferring an output's shape: no work
        packet = func._overloadpacket
        name = str(packet)
        from torch.utils.flop_counter import flop_registry

        if packet in flop_registry:
            flops = flop_registry[packet](*args, **kwargs, out_val=out)
            self.events.append(Event("dot", name, _sig(args), float(flops)))
        elif name in _COLLECTIVE_OPS:
            kind = _COLLECTIVE_OPS[name]
            # the result; a send's (or an op returning only its work) the
            # tensors of its first argument
            moved = (_tensors(args[0]) if kind == "collective-permute"
                     else _tensors(out) or _tensors(args[0]))
            self.events.append(Event(kind, name, _sig(moved),
                                     _nbytes(moved)))
        return out


def analyze(log: List[Event]) -> Dict[str, object]:
    """``{"dot_flops", "collective_bytes", "collective_counts"}`` per
    device, over the reference's five collective kinds."""
    coll = {c: 0.0 for c in _COLLECTIVES}
    cnt = {c: 0.0 for c in _COLLECTIVES}
    flops = 0.0
    for e in log:
        if e.kind == "dot":
            flops += e.value
        else:
            coll[e.kind] += e.value
            cnt[e.kind] += 1
    return {"dot_flops": flops, "collective_bytes": coll,
            "collective_counts": cnt}


def _grouped(log: List[Event], dots: bool):
    rows: Dict[tuple, Dict] = {}
    for e in log:
        if (e.kind == "dot") != dots:
            continue
        key = (e.kind, e.op, e.sig)
        r = rows.setdefault(key, {"comp": f"{e.op}({e.sig})", "op": e.kind,
                                  "per_visit": e.value, "count": 1,
                                  "mult": 0.0, "total": 0.0})
        r["mult"] += 1
        r["total"] += e.value
    return sorted(rows.values(), key=lambda r: -r["total"])


def top_collectives(log: List[Event], k: int = 20):
    """Ranked collectives: one row per (kind, op, local shapes) with keys
    ``comp`` (the op and its shapes), ``op`` (the kind), ``per_visit``
    bytes, ``count`` (1: one op a row), ``mult`` (how often it ran) and
    ``total`` bytes."""
    return _grouped(log, dots=False)[:k]


def top_dots(log: List[Event], k: int = 15):
    """Ranked dots: one row per (op, local shapes) with ``comp``,
    ``per_visit`` FLOPs, ``mult`` and ``total``."""
    return [{key: r[key] for key in ("comp", "per_visit", "mult", "total")}
            for r in _grouped(log, dots=True)[:k]]
