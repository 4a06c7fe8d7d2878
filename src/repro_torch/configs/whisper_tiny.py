"""whisper-tiny [audio]: 4L enc + 4L dec, d=384, 6H, d_ff=1536, vocab=51865.

Enc-dec with conv frame frontend STUBBED (input_specs feeds precomputed
frame embeddings).  [arXiv:2212.04356; unverified]
"""
from repro_torch.models.common import ArchConfig, register

CONFIG = register(ArchConfig(
    name="whisper-tiny", family="audio",
    n_layers=4, enc_layers=4, enc_seq=1500,
    d_model=384, n_heads=6, n_kv_heads=6, d_ff=1536, vocab=51865,
    act="gelu", pos="learned", tie_embeddings=True,
    max_seq=32768 + 8,          # decode_32k cache (config-extended positions)
    grad_accum=1, prefill_chunk=1024,
))
