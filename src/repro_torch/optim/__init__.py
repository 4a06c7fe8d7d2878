from repro_torch.optim.adamw import (  # noqa: F401
    AdamWState,
    adamw_init,
    adamw_update,
    clip_by_global_norm,
    cosine_warmup,
)
