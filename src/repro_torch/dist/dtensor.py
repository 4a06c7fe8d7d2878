"""DTensor helpers of the port's sharded paths.

The step functions and the model run unchanged on DTensor params, batches
and caches; DTensor's sharding propagation places every op.  A few ops
have no sharding strategy, or none that keeps a tensor where the model
needs it, and are handled here by hand:

* :func:`unshard` — ``unbind`` along a sharded dim (the per-layer views of
  stacked leaves whose layer axis the tree rule shards): that dim is
  gathered first.  The same gather makes a dense weight whole along its
  input dim (FSDP's per-layer gather; no contraction is split over ranks).
* :func:`by_heads` — attention (the GQA einsums merge the batch and group
  dims, which DTensor cannot do with both sharded): run on each rank's
  own heads, k/v cut to the groups those heads read; where the layout
  does not allow that, on DTensors with the heads gathered.
* :func:`index_copy_` — in-place row writes into a cache (the k/v rows at
  ``len``, MLA's latent rows): run on each rank's local shard, the rows
  redistributed to the cache's layout.
* :func:`columns_on` — the tied head's transposed table: only the
  ``"model"`` axis keeps sharding its vocab columns, every other axis
  gathered, so the logits stay sharded by batch and vocab (left to
  DTensor, the head gathered the whole microbatch onto every rank).
* :func:`reshape` — a split or merge of a sharded dim that does not
  divide the mesh axis (heads of a column-sharded projection, 4 heads
  over 16 ranks): the changed dims are gathered first, where GSPMD pads.
* :func:`reduce_partial` — the embedding lookup (``lm._embed_tokens``:
  the table's vocab rows gathered, looked up with ``embedding``, whose
  backward DTensor places, where indexing's ``index_put`` fails in torch
  2.11) and the loss's gold-logit gather over vocab-sharded logits: their
  masked partial results are reduced at once (a later reshape of the
  pending value breaks the mask).
* :func:`index_put` — MoE's scatter of routed tokens into the expert
  buffer (``index_put`` has no strategy): the tokens, ids and slots are
  replicated (all-gathered) and every rank scatters the whole buffer on
  its local tensors; autograd flows through ``to_local``/``from_local``.
* :func:`like` — a value added in place into a buffer of another layout
  (a microbatch's gradients into the accumulation buffer): redistributed
  to the buffer's placements first (``Partial`` -> ``Shard`` is a
  reduce-scatter).
* :func:`local_columns` — the quantized product on column-sharded codes
  (``layers.dense``): the codes keep only their column sharding, x is made
  whole along K, and each rank runs the kernel on its own columns.

Plain tensors made inside the model (``arange``, ``full``) meet DTensors
under :func:`implicit`, which treats them as replicated.  None of this
runs for plain tensors: the one-card path is unchanged.
"""

from __future__ import annotations

import contextlib
from typing import Any, Callable, Tuple

import torch

from repro_torch.tree import tree_flatten

__all__ = ["any_dtensor", "by_heads", "columns_on", "implicit",
           "index_copy_", "index_put", "is_dtensor", "like", "local_columns",
           "reduce_partial", "reshape", "unshard"]


_DTENSOR = None


def is_dtensor(x: Any) -> bool:
    global _DTENSOR
    if _DTENSOR is None:        # imported at first use, then one isinstance
        from torch.distributed.tensor import DTensor

        _DTENSOR = DTensor
    return isinstance(x, _DTENSOR)


def any_dtensor(*trees: Any) -> bool:
    if not torch.distributed.is_available():
        return False
    return any(is_dtensor(leaf) for t in trees for leaf in tree_flatten(t)[0])


def implicit(*trees: Any):
    """``implicit_replication()`` when any leaf of ``trees`` is a DTensor
    (plain tensors then act as replicated), else a null context."""
    if any_dtensor(*trees):
        from torch.distributed.tensor.experimental import implicit_replication

        return implicit_replication()
    return contextlib.nullcontext()


def _replicate_where(x, drop: Callable[[int, Any], bool]):
    from torch.distributed.tensor import Replicate

    pl = tuple(Replicate() if drop(i, p) else p
               for i, p in enumerate(x.placements))
    return x if pl == tuple(x.placements) else x.redistribute(
        x.device_mesh, pl)


def _shards(p, dims: Tuple[int, ...], ndim: int) -> bool:
    from torch.distributed.tensor import Shard

    return isinstance(p, Shard) and p.dim % ndim in dims


def unshard(x: Any, dims: Tuple[int, ...]) -> Any:
    """``x`` with tensor dims ``dims`` gathered (replicated over every mesh
    axis that shards them); a plain tensor as it is."""
    if not is_dtensor(x):
        return x
    dims = tuple(d % x.ndim for d in dims)
    return _replicate_where(x, lambda i, p: _shards(p, dims, x.ndim))


def columns_on(w: Any, axis: str = "model") -> Any:
    """A 2-D DTensor ``w`` with its last dim sharded over mesh ``axis``
    alone (when the axis divides it) and replicated over every other;
    a plain tensor as it is."""
    if not is_dtensor(w):
        return w
    from torch.distributed.tensor import Replicate, Shard

    mesh = w.device_mesh
    names = mesh.mesh_dim_names or ()
    pl = [Shard(w.ndim - 1) if name == axis
          and w.shape[-1] % mesh.size(i) == 0 else Replicate()
          for i, name in enumerate(names)]
    return w if tuple(pl) == tuple(w.placements) else w.redistribute(mesh,
                                                                     pl)


def reshape(x: Any, *shape: int) -> Any:
    """``x.reshape(*shape)``; for a DTensor whose layout DTensor cannot
    carry through the reshape, the dims from the first one that changes
    on are gathered and the reshape retried."""
    if not is_dtensor(x):
        return x.reshape(*shape)
    try:
        return x.reshape(*shape)
    except RuntimeError:
        first = next((i for i, (a, b) in enumerate(zip(x.shape, shape))
                      if a != b), 0)
        return unshard(x, tuple(range(first, x.ndim))).reshape(*shape)


def reduce_partial(x: Any) -> Any:
    """``x`` with every pending (partial) placement reduced to
    ``Replicate``; a plain tensor as it is."""
    if not is_dtensor(x):
        return x
    return _replicate_where(x, lambda i, p: p.is_partial())


def like(value: Any, target: Any) -> Any:
    """DTensor ``value`` in ``target``'s placements (for an in-place update
    of ``target``); for a plain ``target``, ``value`` as it is."""
    if not is_dtensor(target):
        return value
    if tuple(value.placements) == tuple(target.placements):
        return value
    return value.redistribute(target.device_mesh, target.placements)


def index_copy_(dst: torch.Tensor, dim: int, index: torch.Tensor,
                src: torch.Tensor) -> torch.Tensor:
    """``dst.index_copy_(dim, index, src)``; on a DTensor ``dst`` (not
    sharded along ``dim``) each rank writes its own shard's rows."""
    if not is_dtensor(dst):
        return dst.index_copy_(dim, index, src)
    if is_dtensor(index):
        index = index.full_tensor()
    src = like(src, dst)
    dst.to_local().index_copy_(dim, index, src.to_local())
    return dst


def index_put(dst: torch.Tensor, indices: Tuple[torch.Tensor, ...],
              values: torch.Tensor) -> torch.Tensor:
    """``dst.index_put_(indices, values)`` on plain tensors (returns
    ``dst``).  With any DTensor argument the result is a new replicated
    DTensor, scattered on each rank's local copies of the replicated
    arguments."""
    if not any(is_dtensor(t) for t in (dst, values, *indices)):
        return dst.index_put_(indices, values)
    from torch.distributed.tensor import DTensor, Replicate

    ref = next(t for t in (values, dst, *indices) if is_dtensor(t))
    mesh = ref.device_mesh
    rep = [Replicate()] * mesh.ndim

    def local(t):
        if not is_dtensor(t):
            return t
        return t.redistribute(mesh, rep).to_local()

    out = torch.index_put(local(dst), tuple(local(i) for i in indices),
                          local(values))
    return DTensor.from_local(out, mesh, rep, run_check=False)


def _head_plan(q, k, v, hdim: int):
    """Each rank's (q heads h0:h1, k/v groups g0:g1, whether k/v are cut
    from a replicated copy), or None where the layout does not allow a
    local run: q sharded on anything but batch and heads, k/v not
    sharded on the batch as q, or heads not split on group bounds."""
    from torch.distributed.tensor import Replicate, Shard

    if not all(is_dtensor(t) for t in (q, k, v)):
        return None
    mesh = q.device_mesh
    if k.device_mesh != mesh or v.device_mesh != mesh:
        return None
    head_dims = []
    for i, (pq, pk, pv) in enumerate(zip(q.placements, k.placements,
                                         v.placements)):
        if pk != pv:
            return None
        if pq == Shard(0) and pk == Shard(0):
            continue
        if pq == Shard(hdim) and pk in (Shard(hdim), Replicate()):
            head_dims.append(i)
            continue
        if pq == Replicate() and pk == Replicate():
            continue
        return None
    if not head_dims:
        return None
    if any(k.placements[i] != k.placements[head_dims[0]] for i in head_dims):
        return None
    cut = k.placements[head_dims[0]] == Replicate()
    H, KV = q.shape[hdim], k.shape[hdim]
    rep = H // KV
    n = 1
    idx = 0
    for i in head_dims:                   # mesh order: outer axis first
        idx = idx * mesh.size(i) + mesh.get_local_rank(i)
        n *= mesh.size(i)
    hl = H // n
    h0, h1 = idx * hl, (idx + 1) * hl
    g0, g1 = h0 // rep, (h1 - 1) // rep + 1
    if hl % (g1 - g0) or (hl >= rep and (hl % rep or h0 % rep)) \
            or (hl < rep and rep % hl):
        return None
    if not cut and (g1 - g0) * n != KV:
        return None
    return head_dims, g0, g1, cut


def by_heads(fn: Callable, q: Any, k: Any, v: Any, hdim: int = 2) -> Any:
    """``fn(q, k, v)``, an attention over heads at ``hdim`` (q's heads in
    GQA groups of k/v's).  On DTensors whose layout splits q's heads over
    some mesh axes (and k/v's with them, or k/v replicated there), each
    rank runs ``fn`` on its own heads and the k/v groups they read, and
    the result has q's layout; otherwise the heads are gathered and
    ``fn`` runs on the DTensors."""
    if not any(is_dtensor(t) for t in (q, k, v)):
        return fn(q, k, v)
    plan = _head_plan(q, k, v, hdim)
    if plan is None:
        q, k, v = (unshard(t, (hdim,)) for t in (q, k, v))
        return fn(q, k, v)
    from torch.distributed.tensor import DTensor, Partial

    head_dims, g0, g1, cut = plan
    if cut:
        # every rank reads a slice of the replicated k/v: its gradient is
        # a partial sum over the head axes
        grad_pl = [Partial() if i in head_dims else p
                   for i, p in enumerate(k.placements)]
        kl = k.to_local(grad_placements=grad_pl).narrow(hdim, g0, g1 - g0)
        vl = v.to_local(grad_placements=grad_pl).narrow(hdim, g0, g1 - g0)
    else:
        kl, vl = k.to_local(), v.to_local()
    out = fn(q.to_local(), kl, vl)
    return DTensor.from_local(out, q.device_mesh, q.placements,
                              run_check=False)


def local_columns(x: Any, w: Any, scale: Any, fn: Callable) -> Any:
    """``fn(x, w, scale)`` per rank on DTensor codes ``w`` (K, N') and
    float32 scale (N,): the column (last-dim) sharding of ``w`` is kept,
    every other axis of ``w`` gathered; ``x`` is made whole along K and
    replicated over the column axes; the scale is cut to the rank's
    columns.  Returns a DTensor of x's batch layout with its last dim
    sharded as ``w``'s columns."""
    from torch.distributed.tensor import (DTensor, Partial, Replicate,
                                          Shard)

    mesh = w.device_mesh
    col = tuple(i for i, p in enumerate(w.placements)
                if _shards(p, (w.ndim - 1,), w.ndim))
    w = _replicate_where(w, lambda i, p: i not in col)
    if not is_dtensor(x):
        x = DTensor.from_local(x, mesh, [Replicate()] * mesh.ndim,
                               run_check=False)
    x = _replicate_where(
        x, lambda i, p: (i in col or isinstance(p, Partial)
                         or _shards(p, (x.ndim - 1,), x.ndim)))
    if is_dtensor(scale):
        scale = scale.full_tensor()
    s = DTensor.from_local(scale, mesh, [Replicate()] * mesh.ndim,
                           run_check=False).redistribute(
        mesh, [Shard(0) if i in col else Replicate()
               for i in range(mesh.ndim)])
    y = fn(x.to_local(), w.to_local(), s.to_local())
    out_pl = [Shard(y.ndim - 1) if i in col else p
              for i, p in enumerate(x.placements)]
    return DTensor.from_local(y, mesh, out_pl, run_check=False)
