"""Architecture configs of the port (public-literature dims; see each module).

Importing this package registers every config; ``--arch <id>`` resolves via
:func:`repro_torch.models.common.get_config`.  This slice of the port
carries the dense ``qwen2.5-3b``, ``lm-tiny`` (the compiled decode
workload) and ``resnet9-paper`` (the paper's backbone, family ``cnn``); the
JAX package's other configs wait for the slices that build their families,
and :func:`~repro_torch.models.common.get_config` raises ``not_ported`` for
them.
"""

from repro_torch.configs import lm_tiny, qwen2_5_3b, resnet9_paper  # noqa: F401

ASSIGNED = ["qwen2.5-3b", "lm-tiny"]
