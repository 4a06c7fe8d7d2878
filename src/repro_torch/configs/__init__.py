"""Architecture configs of the port (public-literature dims; see each module).

Importing this package registers every config; ``--arch <id>`` resolves via
:func:`repro_torch.models.common.get_config`.  The port carries every
config of the JAX package: the dense ``qwen2.5-3b``, ``qwen3-14b`` and
``phi3-medium-14b``, the MLA ``minicpm3-4b``, the MoE ``grok-1-314b`` and
``arctic-480b``, the vision-language ``qwen2-vl-7b``, the SSM
``mamba2-780m``, the hybrid ``zamba2-7b``, the audio encoder-decoder
``whisper-tiny``, ``lm-tiny`` (the compiled decode workload) and
``resnet9-paper`` (the paper's backbone, family ``cnn``).
"""

from repro_torch.configs import (  # noqa: F401
    arctic_480b,
    grok_1_314b,
    lm_tiny,
    mamba2_780m,
    minicpm3_4b,
    phi3_medium_14b,
    qwen2_5_3b,
    qwen2_vl_7b,
    qwen3_14b,
    resnet9_paper,
    whisper_tiny,
    zamba2_7b,
)

ASSIGNED = ["whisper-tiny", "phi3-medium-14b", "qwen2.5-3b", "qwen3-14b",
            "minicpm3-4b", "grok-1-314b", "arctic-480b", "qwen2-vl-7b",
            "mamba2-780m", "zamba2-7b", "lm-tiny"]
