"""Reduced-config factory for CPU smoke tests.

Port copy of the JAX package's ``models/testing.py``: same family/topology
knobs as the full config, only widths, depths and table sizes shrink.
"""

from __future__ import annotations

import dataclasses

from repro_torch.models.common import ArchConfig


def reduce_config(cfg: ArchConfig, **overrides) -> ArchConfig:
    changes = dict(
        d_model=64,
        vocab=97,                      # deliberately ragged (pad-path coverage)
        max_seq=64,
        compute_dtype="float32",       # tight decode-vs-prefill comparisons
        grad_accum=1,
        remat=False,
        prefill_chunk=8,
    )
    if cfg.family != "cnn":
        changes["n_layers"] = 7 if cfg.family == "hybrid" else 2
    if cfg.n_heads:
        changes["n_heads"] = 4
        changes["n_kv_heads"] = max(1, min(cfg.n_kv_heads, 2)) \
            if cfg.n_kv_heads < cfg.n_heads else 4
        changes["head_dim"] = 16
    if cfg.d_ff:
        changes["d_ff"] = 96
    if cfg.attention == "mla":
        changes.update(mla_q_rank=24, mla_kv_rank=16, mla_rope_dim=8,
                       mla_v_head_dim=16)
    if cfg.moe_experts:
        changes.update(moe_experts=4, moe_top_k=2,
                       moe_capacity_factor=8.0)   # no drops -> decode==prefill
    if cfg.ssm_state:
        changes.update(ssm_state=16, ssm_head_dim=8, ssm_chunk=8)
    if cfg.hybrid_period:
        changes.update(hybrid_period=3)
    if cfg.enc_layers:
        changes.update(enc_layers=2, enc_seq=12)
    if cfg.vision_patches:
        changes.update(vision_patches=6)
    changes.update(overrides)
    return dataclasses.replace(cfg, **changes)
