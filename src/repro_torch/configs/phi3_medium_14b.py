"""phi3-medium-14b [dense]: 40L, d=5120, 40H (GQA kv=10), d_ff=17920,
vocab=100352. RoPE + SwiGLU + GQA. [arXiv:2404.14219; unverified]"""
from repro_torch.models.common import ArchConfig, register

CONFIG = register(ArchConfig(
    name="phi3-medium-14b", family="dense",
    n_layers=40, d_model=5120, n_heads=40, n_kv_heads=10, d_ff=17920,
    vocab=100352, rope_theta=1e4, act="swiglu", pos="rope",
    max_seq=32768 + 8, grad_accum=4, prefill_chunk=1024,
))
