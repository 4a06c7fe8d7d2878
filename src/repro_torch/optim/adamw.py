"""AdamW + schedules as plain functions on tensors.

Counterpart of the JAX package's ``optim/adamw.py``.  State mirrors the
params: nested dicts (lists, tuples) of tensors, updated out of place.
Every step computes in float32 as the reference does: the step count and
the schedule are float32 tensors, so ``b1 ** step`` and the learning rate
round like the reference's, not like a Python float (float64); bfloat16
moments are scaled in bfloat16, as the reference's are outside ``jit``.
Weight decay applies to every leaf.
"""

from __future__ import annotations

import math
from typing import Any, Callable, NamedTuple

import torch

from repro_torch.tree import tree_flatten, tree_map


class AdamWState(NamedTuple):
    step: torch.Tensor   # int32 scalar
    m: Any               # first moment  (tree like params)
    v: Any               # second moment (tree like params)


def adamw_init(params: Any, moment_dtype=torch.float32) -> AdamWState:
    def zeros(p):
        # zeros_like keeps a DTensor leaf's layout (and a meta leaf meta)
        return torch.zeros_like(p, dtype=moment_dtype,
                                memory_format=torch.contiguous_format)

    leaves, _ = tree_flatten(params)
    dev = leaves[0].device if leaves else None
    return AdamWState(step=torch.zeros((), dtype=torch.int32, device=dev),
                      m=tree_map(zeros, params), v=tree_map(zeros, params))


@torch.no_grad()
def adamw_update(params: Any, grads: Any, state: AdamWState, lr,
                 b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
                 weight_decay: float = 0.0):
    """Returns (new_params, new_state).  ``lr`` may be a scalar or a
    step -> scalar schedule."""
    step = state.step + 1
    if callable(lr):
        lr = lr(step)
    s = step.to(torch.float32)
    b1c = 1.0 - torch.pow(b1, s)
    b2c = 1.0 - torch.pow(b2, s)

    def upd(p, g, m, v):
        g32 = g.to(torch.float32)
        # a Python float times a moment takes the moment's dtype first, as
        # a weak-typed JAX scalar does (0.9 is 0.8984375 in bf16)
        m_new = torch.tensor(b1, dtype=m.dtype) * m + (1 - b1) * g32
        v_new = (torch.tensor(b2, dtype=v.dtype) * v
                 + (1 - b2) * (g32 * g32))
        mhat = m_new / b1c
        vhat = v_new / b2c
        delta = (mhat / (torch.sqrt(vhat) + eps)
                 + weight_decay * p.to(torch.float32))
        return ((p.to(torch.float32) - lr * delta).to(p.dtype),
                m_new.to(m.dtype), v_new.to(v.dtype))

    flat_p, unflatten = tree_flatten(params)
    out = [upd(*a) for a in zip(flat_p, tree_flatten(grads)[0],
                                tree_flatten(state.m)[0],
                                tree_flatten(state.v)[0])]
    return (unflatten([o[0] for o in out]),
            AdamWState(step=step, m=unflatten([o[1] for o in out]),
                       v=unflatten([o[2] for o in out])))


@torch.no_grad()
def clip_by_global_norm(grads: Any, max_norm: float):
    leaves, _ = tree_flatten(grads)
    gn = torch.sqrt(sum(torch.sum(torch.square(g.to(torch.float32)))
                        for g in leaves))
    scale = torch.clamp(max_norm / torch.clamp(gn, min=1e-9), max=1.0)
    return tree_map(lambda g: (g.to(torch.float32) * scale).to(g.dtype),
                    grads), gn


def cosine_warmup(base_lr: float, warmup: int, total: int,
                  floor: float = 0.1) -> Callable:
    """Linear warmup to ``base_lr``, then cosine decay to ``floor·base_lr``;
    ``sched(step)`` takes an integer tensor and returns a float32 one."""
    def sched(step: torch.Tensor) -> torch.Tensor:
        s = step.to(torch.float32)
        warm = base_lr * s / max(warmup, 1)
        prog = torch.clamp((s - warmup) / max(total - warmup, 1), 0.0, 1.0)
        cos = base_lr * (floor + (1 - floor) * 0.5
                         * (1 + torch.cos(math.pi * prog)))
        return torch.where(s < warmup, warm, cos)
    return sched
