"""Architecture configs of the port (public-literature dims; see each module).

Importing this package registers every config; ``--arch <id>`` resolves via
:func:`repro_torch.models.common.get_config`.  The port carries the dense
``qwen2.5-3b``, ``qwen3-14b`` and ``phi3-medium-14b``, the vision-language
``qwen2-vl-7b``, the SSM ``mamba2-780m``, the hybrid ``zamba2-7b``,
``lm-tiny`` (the compiled decode workload) and ``resnet9-paper`` (the
paper's backbone, family ``cnn``); the JAX package's other configs (MoE,
MLA, audio) wait for the slices that build their families, and
:func:`~repro_torch.models.common.get_config` raises ``not_ported`` for
them.
"""

from repro_torch.configs import (  # noqa: F401
    lm_tiny,
    mamba2_780m,
    phi3_medium_14b,
    qwen2_5_3b,
    qwen2_vl_7b,
    qwen3_14b,
    resnet9_paper,
    zamba2_7b,
)

ASSIGNED = ["phi3-medium-14b", "qwen2.5-3b", "qwen3-14b", "qwen2-vl-7b",
            "mamba2-780m", "zamba2-7b", "lm-tiny"]
