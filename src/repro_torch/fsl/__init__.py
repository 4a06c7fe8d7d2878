"""Few-shot learning pipeline (paper Fig. 1 / Fig. 5): backbone features →
NCM classification, with EASY-style augmented-shot ensembling.

The names the JAX package's ``repro.fsl`` re-exports resolve lazily (PEP
562): ``import repro_torch.fsl`` imports no submodule.
"""

__all__ = ["FSLPipeline", "evaluate_episodes", "pretrain_backbone",
           "class_means", "ncm_classify", "ncm_accuracy"]

_EXPORTS = {
    "FSLPipeline": "repro_torch.fsl.pipeline",
    "evaluate_episodes": "repro_torch.fsl.pipeline",
    "pretrain_backbone": "repro_torch.fsl.pipeline",
    "class_means": "repro_torch.fsl.ncm",
    "ncm_classify": "repro_torch.fsl.ncm",
    "ncm_accuracy": "repro_torch.fsl.ncm",
}


def __getattr__(name: str):
    try:
        module = _EXPORTS[name]
    except KeyError:
        raise AttributeError(
            f"module 'repro_torch.fsl' has no attribute '{name}'") from None
    import importlib

    value = getattr(importlib.import_module(module), name)
    globals()[name] = value
    return value


def __dir__():
    return sorted(set(globals()) | set(_EXPORTS))
