"""arctic-480b [moe]: 35L, d=7168, 56H (GQA kv=8), d_ff=4864,
vocab=32000, MoE 128 experts top-2 + parallel dense residual MLP.
[hf:Snowflake/snowflake-arctic-base; hf]"""
from repro_torch.models.common import ArchConfig, register

CONFIG = register(ArchConfig(
    name="arctic-480b", family="moe",
    n_layers=35, d_model=7168, n_heads=56, n_kv_heads=8, d_ff=4864,
    vocab=32000, moe_experts=128, moe_top_k=2, moe_dense_residual=True,
    rope_theta=1e4, act="swiglu", pos="rope",
    max_seq=32768 + 8, grad_accum=8, prefill_chunk=1024,
))
