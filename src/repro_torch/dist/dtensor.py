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
* :func:`grad_as_value` — a product's output whose gradient DTensor
  would hand back in another layout (the attention output projection's
  came back split along the sequence, and its weight gradient was then
  computed whole on every ``"model"`` rank): the gradient is put back in
  the output's layout first.
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
* :class:`ExpertDispatch` — MoE's dispatch and combine on the float
  banks (expert parallelism): each rank gives its own tokens their
  global slots (the ranks' per-expert counts all-gathered, an exclusive
  prefix in token order), scatters them into a buffer of its own, and an
  all-to-all over the expert axis brings each expert its rows; the
  combine is the inverse all-to-all.  :func:`experts_on` puts a bank in
  the buffer's expert layout.
* :func:`index_put` — the same scatter where the banks are served codes
  (``index_put`` has no strategy): the tokens, ids and slots are
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

__all__ = ["ExpertDispatch", "any_dtensor", "by_heads", "columns_on",
           "experts_on", "grad_as_value", "implicit", "index_copy_",
           "index_put", "is_dtensor", "like", "local_columns",
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


def grad_as_value(y: Any) -> Any:
    """``y`` whose gradient is redistributed to ``y``'s own placements on
    its way back (DTensor may hand it back in another layout, and a
    product then computes its weight's gradient whole); a plain tensor as
    it is."""
    if not is_dtensor(y):
        return y
    from torch.distributed.tensor import DTensor

    return DTensor.from_local(y.to_local(), y.device_mesh, y.placements,
                              run_check=False, shape=y.shape,
                              stride=y.stride())


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


def experts_on(w: Any, ea: Any) -> Any:
    """An expert bank (E, d_in, d_out) in the dispatch buffer's layout:
    its expert dim sharded over mesh dim ``ea`` (None: replicated), its
    output columns kept where another axis shards them, every other dim
    whole; a plain tensor as it is."""
    if not is_dtensor(w):
        return w
    from torch.distributed.tensor import Replicate, Shard

    pl = [Shard(0) if i == ea else p if _shards(p, (2,), 3) else Replicate()
          for i, p in enumerate(w.placements)]
    return w if tuple(pl) == tuple(w.placements) else w.redistribute(
        w.device_mesh, pl)


class ExpertDispatch:
    """MoE's dispatch over ranks (expert parallelism), the reference's
    GSPMD all-to-all written out.  ``flat`` (T, d) and ``ids`` (Tk,) are
    DTensors whose tokens shard over some mesh axes (the token axes, in
    mesh order: the serial token order); ``axis`` names the expert axis.

    * Slots: each rank counts its entries per expert (E integers), the
      counts are all-gathered over the token axes, and an exclusive prefix
      over the ranks in token order is added to each entry's local rank
      (``slots(ids, E, C, base)``), so every kept and dropped entry is the
      serial step's.  ``owner`` (E, C) names the token rank that fills
      each slot (a rank's slots of an expert are one run).
    * Dispatch: each rank scatters its own tokens into a zero (E, C, d)
      buffer; stacked over the token ranks, the buffers go by DTensor's
      redistribute (an all-to-all over each axis that splits the buffer)
      to the ranks that hold each block of the buffer, which keep each
      slot's row from its owner: ``buf`` (E, C, d), equal to the serial
      buffer bit for bit.
    * Combine (:meth:`combine`): the inverse; each rank sends each token
      rank the rows of its block that rank owns (zeros elsewhere), and
      each rank sums its tokens' k weighted rows.

    The expert axis splits the buffer's experts where its size divides E
    (:attr:`experts_axis`), else its slots; every other token axis splits
    the slots, so no two ranks run the same expert on the same slots.
    The slot axes' sizes must divide C (a ``ValueError`` otherwise).
    Gradients flow back through the same exchanges.
    """

    def __init__(self, flat, ids, E: int, C: int, axis: str,
                 slots: Callable):
        from torch.distributed.tensor import DTensor, Replicate, Shard

        mesh = flat.device_mesh
        self.mesh, self.E = mesh, E
        flat = _replicate_where(flat, lambda i, p: not _shards(p, (0,), 2))
        ta = tuple(i for i, p in enumerate(flat.placements)
                   if _shards(p, (0,), 2))
        names = mesh.mesh_dim_names or ()
        # mesh dim -> the buffer dim it splits (0 experts, 1 slots)
        block = {i: 1 for i in ta if mesh.size(i) > 1}
        ea = names.index(axis) if axis in names else None
        if ea is not None and mesh.size(ea) > 1:
            block[ea] = 0 if E % mesh.size(ea) == 0 else 1
        n_e = n_c = 1
        for i, dim in block.items():
            n_e, n_c = (n_e * mesh.size(i), n_c) if dim == 0 else (
                n_e, n_c * mesh.size(i))
        if C % n_c:
            raise ValueError(
                f"MoE capacity {C} does not split over the {n_c} ranks of "
                f"mesh axes {[names[i] for i, b in block.items() if b]}")
        self.ta, self.block = ta, block
        # this rank's block of the buffer: experts e0:e1, slots c0:c1
        self.e0, self.e1, j_c = 0, E, 0
        for i in sorted(block):          # mesh order: outer axis first
            if block[i] == 0:
                n = E // mesh.size(i)
                self.e0, self.e1 = (mesh.get_local_rank(i) * n,
                                    (mesh.get_local_rank(i) + 1) * n)
            else:
                j_c = j_c * mesh.size(i) + mesh.get_local_rank(i)
        self.c0, self.c1 = j_c * C // n_c, (j_c + 1) * C // n_c
        self.tok_pl = [Shard(0) if i in ta else Replicate()
                       for i in range(mesh.ndim)]
        ids = like(ids, flat)
        self.ids = ids.to_local()
        self.r, self.R = 0, 1            # this rank's token block, of R
        for i in ta:
            self.r = self.r * mesh.size(i) + mesh.get_local_rank(i)
            self.R *= mesh.size(i)
        ex = torch.arange(E, device=self.ids.device)
        cnt = (self.ids[:, None] == ex).sum(0).to(torch.int32)
        counts = DTensor.from_local(cnt[None], mesh, self.tok_pl,
                                    run_check=False).full_tensor()  # (R, E)
        self.keep_l, self.slot = slots(self.ids, E, C,
                                       counts[:self.r].sum(0))
        ends = torch.cumsum(counts, 0).T                          # (E, R)
        c = torch.arange(C, device=ends.device)
        self.owner = (ends[:, :, None] <= c).sum(1).clamp_max(
            self.R - 1)                                           # (E, C)

        x = flat.to_local()
        T, d = x.shape
        k = self.ids.shape[0] // T
        tok = torch.arange(T, device=x.device)[:, None].expand(T, k)
        src = torch.zeros((E, C + 1, d), dtype=x.dtype, device=x.device
                          ).index_put_((self.ids, self.slot),
                                       x[tok.reshape(-1)]
                                       * self.keep_l[:, None].to(x.dtype))
        stack = DTensor.from_local(src[None, :, :C], mesh, self.tok_pl,
                                   run_check=False)            # (R, E, C, d)
        got = stack.redistribute(mesh, self._at(1)).to_local()
        own = self._own()
        self.buf = DTensor.from_local(
            got.gather(0, own[None, :, :, None].expand(1, *own.shape, d))[0],
            mesh, self._at(0), run_check=False)
        self.keep = DTensor.from_local(self.keep_l, mesh, self.tok_pl,
                                       run_check=False)

    @property
    def experts_axis(self):
        """The mesh dim that splits the buffer's experts, or None."""
        return next((i for i, dim in self.block.items() if dim == 0), None)

    def _at(self, lead: int) -> list:
        """The buffer's placements, after ``lead`` leading dims."""
        from torch.distributed.tensor import Replicate, Shard

        return [Shard(lead + self.block[i]) if i in self.block
                else Replicate() for i in range(self.mesh.ndim)]

    def _own(self):
        return self.owner[self.e0:self.e1, self.c0:self.c1]

    def combine(self, out, gates):
        """(T, d): each token's k rows of ``out`` (E, C, d), each times
        its gate (``gates`` (T, k)), summed; d sharded as ``out``'s."""
        from torch.distributed.tensor import (DTensor, Partial, Replicate,
                                              Shard)

        mesh, ta, block = self.mesh, self.ta, self.block
        at = self._at(0)
        pl = [at[i] if i in block else p
              if i not in ta and _shards(p, (2,), 3) else Replicate()
              for i, p in enumerate(out.placements)]
        dax = tuple(i for i, p in enumerate(pl) if i not in block
                    and _shards(p, (2,), 3))
        if tuple(pl) != tuple(out.placements):
            out = out.redistribute(mesh, pl)
        x = out.to_local(grad_placements=pl)              # (n_e, n_c, d')
        # the rows each token rank owns
        ranks = torch.arange(self.R, device=x.device)
        mask = self._own()[None] == ranks[:, None, None]  # (R, n_e, n_c)
        pieces = torch.where(mask[..., None], x[None],
                             torch.zeros((), dtype=x.dtype, device=x.device))
        at = self._at(1)
        stack = DTensor.from_local(pieces, mesh, [
            at[i] if i in block else Shard(0) if i in ta else
            Shard(3) if i in dax else Replicate()
            for i in range(mesh.ndim)], run_check=False)
        mine = stack.redistribute(mesh, [
            Shard(0) if i in ta else Shard(3) if i in dax else Replicate()
            for i in range(mesh.ndim)]).to_local()[0]     # (E, C, d')
        E, d = self.E, mine.shape[-1]
        cd = mine.dtype
        mine = torch.cat([mine, torch.zeros((E, 1, d), dtype=cd,
                                            device=mine.device)], dim=1)
        if tuple(gates.placements) != tuple(self.tok_pl):
            gates = gates.redistribute(mesh, self.tok_pl)
        # the gates' gradient sums over d: partial where d is sharded
        g = gates.to_local(grad_placements=[
            Partial() if i in dax else p for i, p in enumerate(self.tok_pl)])
        T, k = g.shape
        weighted = mine[self.ids, self.slot] * (
            g.reshape(T * k, 1).to(cd) * self.keep_l[:, None].to(cd))
        y = weighted.reshape(T, k, d).sum(1)
        return DTensor.from_local(y, mesh, [
            Shard(0) if i in ta else Shard(1) if i in dax else Replicate()
            for i in range(mesh.ndim)], run_check=False)


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
