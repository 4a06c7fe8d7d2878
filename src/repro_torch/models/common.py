"""Architecture configuration: one schema for every model family.

PyTorch-port copy of the JAX package's ``models/common.py``: the same
:class:`ArchConfig` fields and derived sizes, so a config file reads the
same in both packages.  Every ``repro_torch/configs/<id>.py`` instantiates
it and registers itself on import; :func:`get_config` imports
``repro_torch.configs.<id>`` on first use.  The port builds every family:
``dense`` (with MLA attention), ``moe``, ``vlm``, ``ssm`` and ``hybrid``
in :mod:`repro_torch.models.lm`, ``audio`` in
:mod:`repro_torch.models.whisper`.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

from repro_torch.core.quant import QuantConfig

__all__ = ["ArchConfig", "register", "get_config", "list_configs"]


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    # -- identity ----------------------------------------------------------
    name: str
    family: str                      # dense | moe | ssm | hybrid | vlm | audio
    # -- transformer core ----------------------------------------------------
    n_layers: int = 0
    d_model: int = 0
    n_heads: int = 0
    n_kv_heads: int = 0
    d_ff: int = 0
    vocab: int = 0
    head_dim: int = 0                # 0 -> d_model // n_heads
    qkv_bias: bool = False
    qk_norm: bool = False
    tie_embeddings: bool = False
    norm_eps: float = 1e-6
    rope_theta: float = 1e6
    max_seq: int = 8192
    act: str = "swiglu"              # swiglu | gelu
    pos: str = "rope"                # rope | mrope | learned | none
    # -- attention variant -------------------------------------------------
    attention: str = "gqa"           # gqa | mla
    mla_q_rank: int = 0
    mla_kv_rank: int = 0
    mla_rope_dim: int = 0            # per-head rope dims (MLA splits nope/rope)
    mla_v_head_dim: int = 0
    # -- MoE ----------------------------------------------------------------
    moe_experts: int = 0
    moe_top_k: int = 0
    moe_dense_residual: bool = False  # arctic: dense FFN in parallel w/ MoE
    moe_capacity_factor: float = 1.25
    # -- SSM (Mamba2 / SSD) -------------------------------------------------
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_conv: int = 4
    ssm_groups: int = 1
    ssm_chunk: int = 256
    # -- hybrid (zamba2-style): every `period`-th slot is a SHARED attn block
    hybrid_period: int = 0
    # -- encoder-decoder (whisper) -------------------------------------------
    enc_layers: int = 0
    enc_seq: int = 0                 # precomputed frame-embedding length
    # -- vlm ------------------------------------------------------------------
    vision_patches: int = 0          # precomputed patch-embedding count
    # -- numerics / technique -------------------------------------------------
    quant: Optional[QuantConfig] = None   # QAT grid (paper technique); None=fp
    weight_serving_bits: int = 0          # 0=bf16, 8=w8a16, 4=w4a16 decode path
    compute_dtype: str = "bfloat16"
    # -- distribution knobs ----------------------------------------------------
    grad_accum: int = 1              # microbatches inside train_step
    remat: bool = True               # activation checkpointing per block
    remat_policy: str = ""           # "" | "tp_outputs" (save post-AR acts)
    prefill_chunk: int = 1024        # q-block for chunked (flash-style) attn
    scan_layers: bool = True         # lax.scan over stacked homogeneous blocks

    # -- derived -------------------------------------------------------------
    @property
    def hd(self) -> int:
        return self.head_dim or (self.d_model // max(self.n_heads, 1))

    @property
    def vocab_padded(self) -> int:
        """Embedding-table size: vocab rounded up to a multiple of 256 so the
        vocab axis shards evenly over 16-way TP (MaxText-style padding).
        Loss/sampling only ever index the true ``vocab`` range."""
        return ((self.vocab + 255) // 256) * 256

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    def n_params(self) -> int:
        """Analytic parameter count (used for MODEL_FLOPS = 6·N·D)."""
        d, f, V = self.d_model, self.d_ff, self.vocab
        hd, H, KV = self.hd, self.n_heads, self.n_kv_heads
        n = V * d  # embed
        if not self.tie_embeddings:
            n += V * d
        def attn_params():
            if self.attention == "mla":
                qr, kvr, rd = self.mla_q_rank, self.mla_kv_rank, self.mla_rope_dim
                vhd = self.mla_v_head_dim or hd
                return (d * qr + qr * H * (hd + rd)        # q down/up
                        + d * (kvr + rd)                   # kv down + shared rope k
                        + kvr * H * (hd + vhd)             # kv up
                        + H * vhd * d)                     # out
            return d * H * hd + 2 * d * KV * hd + H * hd * d
        def mlp_params():
            per = 3 * d * f if self.act == "swiglu" else 2 * d * f
            return per
        def moe_params():
            return self.moe_experts * mlp_params() + d * self.moe_experts \
                + (mlp_params() if self.moe_dense_residual else 0)
        def ssm_params():
            di, N, G, P = self.d_inner, self.ssm_state, self.ssm_groups, self.ssm_head_dim
            nh = di // P
            return (d * (2 * di + 2 * G * N + nh)   # in_proj (z,x,B,C,dt)
                    + self.ssm_conv * (di + 2 * G * N)  # conv1d
                    + 2 * nh                        # A_log, D
                    + di * d)                       # out_proj
        if self.family == "ssm":
            n += self.n_layers * (ssm_params() + d)
        elif self.family == "hybrid":
            n_shared = self.n_layers // max(self.hybrid_period, 1)
            n_mamba = self.n_layers - n_shared
            n += n_mamba * (ssm_params() + d)
            n += attn_params() + mlp_params() + 2 * d  # ONE shared block
        else:
            per_layer = attn_params() + 2 * d
            if self.moe_experts:
                per_layer += moe_params()
            else:
                per_layer += mlp_params()
            n += self.n_layers * per_layer
        if self.enc_layers:  # whisper encoder + cross-attn in decoder
            enc = self.enc_layers * (attn_params() + mlp_params() + 2 * d)
            cross = self.n_layers * attn_params()
            n += enc + cross + self.enc_seq * d  # enc pos embed
        n += d  # final norm
        return n

    def n_active_params(self) -> int:
        """Active params per token (MoE: top-k experts only)."""
        if not self.moe_experts:
            return self.n_params()
        full = self.n_params()
        per = 3 * self.d_model * self.d_ff if self.act == "swiglu" else 2 * self.d_model * self.d_ff
        inactive = self.n_layers * (self.moe_experts - self.moe_top_k) * per
        return full - inactive


_REGISTRY: Dict[str, ArchConfig] = {}


def register(cfg: ArchConfig) -> ArchConfig:
    _REGISTRY[cfg.name] = cfg
    return cfg


# the JAX package's configs the port does not build: none since the MoE,
# MLA and audio families were ported
UNPORTED: tuple = ()


def get_config(name: str) -> ArchConfig:
    """The registered config ``name``; configs register on import.  A name
    the port does not know raises ``KeyError``."""
    if name not in _REGISTRY:
        import importlib
        mod = name.replace("-", "_").replace(".", "_")
        full = f"repro_torch.configs.{mod}"
        try:
            importlib.import_module(full)
        except ModuleNotFoundError as e:
            if e.name != full:
                raise
            raise KeyError(f"unknown config {name!r}") from None
    return _REGISTRY[name]


def list_configs():
    import importlib
    importlib.import_module("repro_torch.configs")
    return sorted(_REGISTRY)
