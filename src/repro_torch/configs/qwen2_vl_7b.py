"""qwen2-vl-7b [vlm]: 28L, d=3584, 28H (GQA kv=4), d_ff=18944,
vocab=152064. M-RoPE; dynamic-resolution ViT frontend STUBBED
(input_specs feeds precomputed patch embeddings + 3-stream positions).
[arXiv:2409.12191; hf]"""
from repro_torch.models.common import ArchConfig, register

CONFIG = register(ArchConfig(
    name="qwen2-vl-7b", family="vlm",
    n_layers=28, d_model=3584, n_heads=28, n_kv_heads=4, d_ff=18944,
    vocab=152064, vision_patches=256, pos="mrope", rope_theta=1e6,
    act="swiglu", max_seq=32768 + 8, grad_accum=2, prefill_chunk=1024,
))
