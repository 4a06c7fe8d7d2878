"""minicpm3-4b [dense/MLA]: 62L, d=2560, 40H, d_ff=6400, vocab=73448.
Multi-head Latent Attention (compressed KV cache).
[hf:openbmb/MiniCPM3-4B; hf]"""
from repro_torch.models.common import ArchConfig, register

CONFIG = register(ArchConfig(
    name="minicpm3-4b", family="dense",
    n_layers=62, d_model=2560, n_heads=40, n_kv_heads=40, d_ff=6400,
    vocab=73448, attention="mla", head_dim=64,
    mla_q_rank=768, mla_kv_rank=256, mla_rope_dim=32, mla_v_head_dim=64,
    rope_theta=1e4, act="swiglu", pos="rope",
    max_seq=32768 + 8, grad_accum=2, prefill_chunk=1024,
))
