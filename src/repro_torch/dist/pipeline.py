"""GPipe-style pipeline parallelism over the ranks of a mesh axis.

Counterpart of the JAX package's ``dist/pipeline.py`` (``shard_map`` +
``ppermute``).  Each rank on the pipeline axis owns one stage's weights.
Microbatches enter stage 0 one per tick; activations rotate one hop per
tick around the ring (:class:`PPermute`, a send to the next rank and a
receive from the previous one); results leave the last stage after
``n_stages - 1`` fill ticks.  The schedule is ``n_micro + n_stages - 1``
ticks long, the classic GPipe bubble.  Forward and backward are both
exact: the ring's transpose is the reverse rotation, and the closing
sum-broadcast (:class:`SumToReplicated`) hands each rank the cotangent of
the replicated output as it is.
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.distributed as dist

__all__ = ["PPermute", "SumToReplicated", "pipeline_apply"]


def _rotate(t: torch.Tensor, group, shift: int) -> torch.Tensor:
    """``t`` sent ``shift`` ranks up the group's ring; returns what came
    from ``shift`` ranks down."""
    n = dist.get_world_size(group)
    me = dist.get_rank(group)
    t = t.contiguous()
    out = torch.empty_like(t)
    to = dist.get_global_rank(group, (me + shift) % n)
    frm = dist.get_global_rank(group, (me - shift) % n)
    ops = [dist.P2POp(dist.isend, t, to, group),
           dist.P2POp(dist.irecv, out, frm, group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return out


class PPermute(torch.autograd.Function):
    """``jax.lax.ppermute`` with the permutation ``i -> i + 1 (mod n)``
    over a process group: forward sends to the next rank and receives from
    the previous one; backward rotates the cotangent the other way."""

    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        return _rotate(t, group, 1)

    @staticmethod
    def backward(ctx, ct):
        return _rotate(ct, ctx.group, -1), None


class SumToReplicated(torch.autograd.Function):
    """``psum`` into a value every rank holds alike: forward all-reduces
    (sum); backward passes the cotangent through.  Each rank then computes
    the same downstream loss on the replicated value, so its cotangent is
    already the whole loss's; summing it over ranks would count the loss
    once per rank."""

    @staticmethod
    def forward(ctx, t, group):
        t = t.clone()
        dist.all_reduce(t, group=group)
        return t

    @staticmethod
    def backward(ctx, ct):
        return ct, None


def pipeline_apply(stage_fn: Callable, ws, x: torch.Tensor, mesh,
                   axis: str = None) -> torch.Tensor:
    """Apply ``n_stages`` stages to ``n_micro`` microbatches over a
    pipeline.

    Args:
      stage_fn: ``(w, activation) -> activation`` (shape-preserving).
      ws: stacked per-stage weights, leading dim ``n_stages``: a DTensor
        sharded on dim 0 over ``axis`` (the reference's ``P(axis)``; its
        gradient is then the whole stack's), or a plain tensor holding
        every stage, of which each rank uses its own (its gradient then
        reaches that rank's stage only).
      x: microbatched input ``(n_micro, mb, ...)``, the same on every rank.
      mesh: a ``DeviceMesh`` of ranks whose ``axis`` carries the stages.
      axis: mesh axis name (defaults to the mesh's first axis).

    Returns the output of the final stage for every microbatch, in order,
    on every rank.
    """
    axis = axis or mesh.mesh_dim_names[0]
    n_stages = ws.shape[0]
    width = mesh.size(mesh.mesh_dim_names.index(axis))
    if width != n_stages:
        raise ValueError(
            f"{n_stages} stages need a {n_stages}-wide '{axis}' axis, "
            f"got {width}")
    group = mesh.get_group(axis)
    stage = dist.get_rank(group)
    from repro_torch.dist.dtensor import is_dtensor

    w = ws.to_local()[0] if is_dtensor(ws) else ws[stage]
    n_micro = x.shape[0]
    n_ticks = n_micro + n_stages - 1
    is_first, is_last = stage == 0, stage == n_stages - 1

    first = torch.full((), is_first, dtype=torch.bool, device=x.device)
    last = torch.full((), is_last, dtype=torch.bool, device=x.device)
    state = torch.zeros_like(x[0])
    outs = []
    for t in range(n_ticks):
        # a select, not a Python branch: the first stage's received state
        # stays in the graph (with a zero cotangent), so every rank runs
        # every rotation's backward and the ring's sends pair up
        state = torch.where(first, x[min(t, n_micro - 1)], state)
        y = stage_fn(w, state)
        if t >= n_stages - 1:
            outs.append(y)
        if t < n_ticks - 1:          # the last tick's rotation feeds nothing
            state = PPermute.apply(y, group)
    # only the last stage holds real outputs; sum-broadcast to all (every
    # rank's outputs stay in its graph, so every rank runs the backward)
    out = torch.where(last, torch.stack(outs), torch.zeros_like(x))
    return SumToReplicated.apply(out, group)
