"""grok-1-314b [moe]: 64L, d=6144, 48H (GQA kv=8), d_ff=32768,
vocab=131072, MoE 8 experts top-2. [hf:xai-org/grok-1; unverified]"""
from repro_torch.models.common import ArchConfig, register

CONFIG = register(ArchConfig(
    name="grok-1-314b", family="moe",
    n_layers=64, d_model=6144, n_heads=48, n_kv_heads=8, d_ff=32768,
    vocab=131072, moe_experts=8, moe_top_k=2,
    rope_theta=1e4, act="swiglu", pos="rope",
    max_seq=32768 + 8, grad_accum=8, prefill_chunk=1024,
))
