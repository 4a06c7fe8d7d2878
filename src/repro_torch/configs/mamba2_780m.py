"""mamba2-780m [ssm]: 48L, d=1536, attn-free, vocab=50280, ssm_state=128.
SSD (state-space duality), chunked. [arXiv:2405.21060; unverified]"""
from repro_torch.models.common import ArchConfig, register

CONFIG = register(ArchConfig(
    name="mamba2-780m", family="ssm",
    n_layers=48, d_model=1536, vocab=50280,
    ssm_state=128, ssm_head_dim=64, ssm_expand=2, ssm_conv=4, ssm_groups=1,
    ssm_chunk=256, pos="none", tie_embeddings=True,
    max_seq=524288 + 8, grad_accum=2,
))
