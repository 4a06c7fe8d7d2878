"""repro_torch — the PyTorch/CUDA port of the bit-width-aware design
environment for few-shot learning.

Public compiler surface::

    import repro_torch
    dm = repro_torch.compile(params, repro_torch.QuantConfig.paper_w6a4(),
                             recipe="resnet9", datapath="int")
    features = dm(x)                      # runs on the card

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``; with
no CUDA device and no explicit CPU request they raise.  Attribute access is
lazy (PEP 562), like the JAX package's ``repro``: ``import repro_torch``
imports no submodule and never builds a kernel.  The port imports neither
``jax`` nor anything of the JAX package ``repro``.
"""

__all__ = ["compile", "DeployedModel", "PassManager", "PassOrderError",
           "PassVerificationError", "BuildRecipe", "recipe",
           "register_recipe", "register_pass", "QuantConfig",
           "FixedPointSpec", "Graph", "execute"]

_EXPORTS = {
    "compile": ("repro_torch.core.deploy", "compile"),
    "DeployedModel": ("repro_torch.core.deploy", "DeployedModel"),
    "PassManager": ("repro_torch.core.passes", "PassManager"),
    "PassOrderError": ("repro_torch.core.passes", "PassOrderError"),
    "PassVerificationError": ("repro_torch.core.passes",
                              "PassVerificationError"),
    "register_pass": ("repro_torch.core.passes", "register_pass"),
    "BuildRecipe": ("repro_torch.core.recipes", "BuildRecipe"),
    "recipe": ("repro_torch.core.recipes", "recipe"),
    "register_recipe": ("repro_torch.core.recipes", "register_recipe"),
    "QuantConfig": ("repro_torch.core.quant", "QuantConfig"),
    "FixedPointSpec": ("repro_torch.core.quant", "FixedPointSpec"),
    "Graph": ("repro_torch.core.graph", "Graph"),
    "execute": ("repro_torch.core.graph", "execute"),
}


def __getattr__(name: str):
    try:
        module, attr = _EXPORTS[name]
    except KeyError:
        raise AttributeError(
            f"module 'repro_torch' has no attribute '{name}'") from None
    import importlib

    value = getattr(importlib.import_module(module), attr)
    globals()[name] = value
    return value


def __dir__():
    return sorted(set(globals()) | set(_EXPORTS))
