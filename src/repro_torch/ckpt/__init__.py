from repro_torch.ckpt.compile_cache import (  # noqa: F401
    CompileCache,
    graph_fingerprint,
)
from repro_torch.ckpt.manager import (  # noqa: F401
    CheckpointManager,
    content_key,
    restore_resharded,
)
