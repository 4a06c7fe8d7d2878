"""zamba2-7b [hybrid]: 81 layer-slots, d=3584, vocab=32000, ssm_state=64.
Mamba2 blocks + ONE shared attention+MLP block invoked every 6th slot
(weight re-use across invocations, distinct KV caches per invocation —
zamba2's parameter-efficiency trick; per-invocation LoRA adapters omitted,
noted in DESIGN.md). [arXiv:2411.15242; unverified]"""
from repro_torch.models.common import ArchConfig, register

CONFIG = register(ArchConfig(
    name="zamba2-7b", family="hybrid",
    n_layers=81, d_model=3584, n_heads=32, n_kv_heads=32, d_ff=14336,
    vocab=32000, hybrid_period=6,
    ssm_state=64, ssm_head_dim=64, ssm_expand=2, ssm_conv=4, ssm_groups=1,
    ssm_chunk=256, rope_theta=1e4, act="swiglu", pos="rope",
    max_seq=524288 + 8, grad_accum=4, prefill_chunk=1024,
))
