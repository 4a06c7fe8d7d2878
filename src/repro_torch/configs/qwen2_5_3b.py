"""qwen2.5-3b [dense]: 36L, d=2048, 16H (GQA kv=2), d_ff=11008,
vocab=151936, QKV bias. [hf:Qwen/Qwen2.5-0.5B; hf]"""
from repro_torch.models.common import ArchConfig, register

CONFIG = register(ArchConfig(
    name="qwen2.5-3b", family="dense",
    n_layers=36, d_model=2048, n_heads=16, n_kv_heads=2, d_ff=11008,
    vocab=151936, qkv_bias=True, rope_theta=1e6, act="swiglu", pos="rope",
    tie_embeddings=True, max_seq=32768 + 8, grad_accum=2, prefill_chunk=1024,
))
