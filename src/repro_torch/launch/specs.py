"""Assigned input-shape sets and meta-tensor stand-ins per (arch × shape).

Counterpart of the JAX package's ``launch/specs.py``.  Every tensor the
dry run feeds a step comes from here: meta-device tensors of the
reference's shapes and dtypes, with no storage and no random draws.
Parameters are built by the real ``init_params`` under
``FakeTensorMode`` (the draws are faked, not made) and handed back as
meta tensors; a MoE config's expert banks are drawn for one expert and
widened here (``init_params`` draws a bank one expert at a time).  ``cell_supported`` encodes the assignment's skip rules
(long_500k only for sub-quadratic families).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import torch

from repro_torch.models.common import ArchConfig
from repro_torch.tree import tree_map

SHAPES: Dict[str, Dict] = {
    "train_4k": dict(kind="train", seq=4096, batch=256),
    "prefill_32k": dict(kind="prefill", seq=32768, batch=32),
    "decode_32k": dict(kind="decode", seq=32768, batch=128),
    "long_500k": dict(kind="decode", seq=524288, batch=1),
}

META = torch.device("meta")


def _sds(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device=META)


def _as_meta(tree):
    return tree_map(lambda t: _sds(tuple(t.shape), t.dtype), tree)


def cell_supported(cfg: ArchConfig, shape_name: str) -> Tuple[bool, str]:
    SHAPES[shape_name]            # an unknown shape raises, as the reference
    if shape_name == "long_500k" and cfg.family not in ("ssm", "hybrid"):
        return False, ("full O(L^2) attention at 524k is not deployable; "
                       "assignment says skip for pure full-attention archs")
    return True, ""


def batch_specs(cfg: ArchConfig, shape_name: str) -> Dict[str, torch.Tensor]:
    """Batch tensors for the cell's entry point (meta)."""
    sh = SHAPES[shape_name]
    B, S = sh["batch"], sh["seq"]
    kind = sh["kind"]
    i32, bf16 = torch.int32, torch.bfloat16

    if kind == "train":
        # pre-microbatched (n_micro, mb, ...), as make_train_step loops
        n_micro = max(cfg.grad_accum, 1)
        assert B % n_micro == 0, (cfg.name, shape_name)
        mb = B // n_micro

        if cfg.family == "audio":
            return {
                "frames": _sds((n_micro, mb, cfg.enc_seq, cfg.d_model), bf16),
                "tokens": _sds((n_micro, mb, S), i32),
                "labels": _sds((n_micro, mb, S), i32),
            }
        if cfg.family == "vlm":
            P_ = cfg.vision_patches
            return {
                "patch_embeds": _sds((n_micro, mb, P_, cfg.d_model), bf16),
                "tokens": _sds((n_micro, mb, S - P_), i32),
                "labels": _sds((n_micro, mb, S - P_), i32),
            }
        return {"tokens": _sds((n_micro, mb, S), i32),
                "labels": _sds((n_micro, mb, S), i32)}

    if kind == "prefill":
        if cfg.family == "audio":
            return {"frames": _sds((B, cfg.enc_seq, cfg.d_model), bf16),
                    "tokens": _sds((B, S), i32)}
        if cfg.family == "vlm":
            P_ = cfg.vision_patches
            return {"patch_embeds": _sds((B, P_, cfg.d_model), bf16),
                    "tokens": _sds((B, S - P_), i32)}
        return {"tokens": _sds((B, S), i32)}

    # decode: one new token against a seq_len-deep cache
    return {"tokens": _sds((B, 1), i32)}


def _module(cfg: ArchConfig):
    if cfg.family == "audio":
        from repro_torch.models import whisper
        return whisper
    from repro_torch.models import lm
    return lm


def cache_specs(cfg: ArchConfig, shape_name: str, dtype=torch.bfloat16):
    """Decode-cache stand-ins: the real ``init_cache`` on the meta device."""
    sh = SHAPES[shape_name]
    return _module(cfg).init_cache(cfg, sh["batch"], sh["seq"], dtype=dtype,
                                   device=META)


def _widen_experts(tree, E: int):
    """A one-expert params tree with every MoE leaf widened to ``E``
    experts: the router's columns, the banks' expert dim."""
    if not isinstance(tree, dict):
        return tree
    if "moe" not in tree:
        return {k: _widen_experts(v, E) for k, v in tree.items()}
    moe = dict(tree["moe"])
    moe["router"] = tree_map(
        lambda t: torch.empty((*t.shape[:-1], E), dtype=t.dtype),
        moe["router"])
    for k in ("w_gate", "w_up", "w_down"):
        t = moe[k]
        moe[k] = torch.empty((*t.shape[:-3], E, *t.shape[-2:]),
                             dtype=t.dtype)
    return {**tree, "moe": moe}


def param_specs(cfg: ArchConfig, serving_bits: int = 0, dtype=None):
    """Parameter stand-ins (optionally serving-quantized, float32 leaves
    cast to ``dtype``: serving uses bf16, >50B training bf16 states)."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    E = cfg.moe_experts
    with FakeTensorMode():
        p = _module(cfg).init_params(
            torch.Generator(),
            dataclasses.replace(cfg, moe_experts=1) if E > 1 else cfg, "cpu")
        if E > 1:
            p = _widen_experts(p, E)
        if dtype is not None:
            p = tree_map(lambda a: a.to(dtype)
                         if a.dtype == torch.float32 else a, p)
        if serving_bits:
            from repro_torch.launch.steps import quantize_tree_for_serving
            p = quantize_tree_for_serving(p, serving_bits)
    return _as_meta(p)          # outside the mode: plain meta tensors
