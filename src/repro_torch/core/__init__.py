"""Core: arbitrary-bit-width quantization + FINN-style graph compilation.

Layering (bottom to top), as in the JAX package:

quant  →  graph (IR + interpreter)  →  transforms (rewrites)  →
passes (PassManager + registry)  →  recipes (per-arch orderings)  →
datatypes (integer lowering)  →  deploy (``compile`` → ``DeployedModel``)

The names the JAX package's ``repro.core`` re-exports resolve lazily (PEP
562): ``import repro_torch.core`` imports no submodule.  The deprecated
build-step shims (``core/build.py``) are among them, as in the reference.
"""

_EXPORTS = {
    "FixedPointSpec": ("quant", "FixedPointSpec"),
    "QuantConfig": ("quant", "QuantConfig"),
    "dequantize": ("quant", "dequantize"),
    "fake_quant": ("quant", "fake_quant"),
    "multithreshold": ("quant", "multithreshold"),
    "pack_int4": ("quant", "pack_int4"),
    "quantize": ("quant", "quantize"),
    "thresholds_for": ("quant", "thresholds_for"),
    "unpack_int4": ("quant", "unpack_int4"),
    "Graph": ("graph", "Graph"),
    "GraphBuildError": ("graph", "GraphBuildError"),
    "Node": ("graph", "Node"),
    "execute": ("graph", "execute"),
    "GraphPass": ("passes", "GraphPass"),
    "PassManager": ("passes", "PassManager"),
    "PassOrderError": ("passes", "PassOrderError"),
    "PassVerificationError": ("passes", "PassVerificationError"),
    "PassTrace": ("passes", "PassTrace"),
    "register_pass": ("passes", "register_pass"),
    "BuildRecipe": ("recipes", "BuildRecipe"),
    "list_recipes": ("recipes", "list_recipes"),
    "recipe": ("recipes", "recipe"),
    "register_lazy_recipe": ("recipes", "register_lazy_recipe"),
    "register_recipe": ("recipes", "register_recipe"),
    "DeployedModel": ("deploy", "DeployedModel"),
    "lower_graph": ("deploy", "lower_graph"),
    "compile_graph": ("deploy", "compile"),
    "DEFAULT_MLP_STEPS": ("build", "DEFAULT_MLP_STEPS"),
    "RESNET9_BUILD_STEPS": ("build", "RESNET9_BUILD_STEPS"),
    "build_dataflow": ("build", "build_dataflow"),
}

__all__ = sorted(_EXPORTS)


def __getattr__(name: str):
    try:
        module, attr = _EXPORTS[name]
    except KeyError:
        raise AttributeError(
            f"module 'repro_torch.core' has no attribute '{name}'") from None
    import importlib

    value = getattr(importlib.import_module(f"repro_torch.core.{module}"),
                    attr)
    globals()[name] = value
    return value


def __dir__():
    return sorted(set(globals()) | set(_EXPORTS))
