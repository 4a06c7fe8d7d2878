"""Architecture build recipes: named, registered pass orderings.

The paper's Sec. III-A point is that the FINN build-step list is
*architecture-dependent* — the tutorial MLP list cannot build ResNet-9; the
customized list can.  A :class:`BuildRecipe` makes that list a first-class,
registered artifact: models register their own recipe next to their export
code (``repro_torch/models/resnet9.py`` registers ``"resnet9"``) and
``repro_torch.compile(graph, qcfg, recipe="resnet9")`` looks it up — new backbones
(PEFSL variants, MLPerf-Tiny CNNs) plug in without touching anything under
``repro_torch/core``.

Recipes are validated against the pass registry at registration time (every
pass name must exist) and order-checked by the PassManager at build time.

Workload hooks
--------------
A recipe may serve several *workloads*; each needs a different bundle of
callables from the model module, so :meth:`BuildRecipe.workload_hooks`
resolves a named hook bundle: ``recipe("resnet9").workload_hooks("fsl")``
returns an :class:`FSLHooks`, ``recipe("lm-decode").workload_hooks("decode")``
the LM module's decode bundle.
"""

from __future__ import annotations

import dataclasses
import importlib
import warnings
from typing import Any, Callable, Dict, Mapping, Optional, Sequence, Tuple

from repro_torch.core import passes as P

__all__ = ["BuildRecipe", "FSLHooks", "register_recipe",
           "register_lazy_recipe", "recipe", "list_recipes"]


@dataclasses.dataclass(frozen=True)
class FSLHooks:
    """The few-shot workload's hook bundle (see
    :meth:`BuildRecipe.workload_hooks`):

    * ``init_params(gen, width, device) -> params`` — a fresh backbone tree;
    * ``feature_dim(width) -> int`` — the backbone's feature width;
    * ``forward(params, x, qcfg, width) -> feats`` — the QAT forward;
    * ``quant_layers(width) -> {"names": [...], "coupled_act": [[...]]}`` —
      the architecture's quantizable layer names plus the groups whose
      activation grids a residual add forces onto a common fraction (the
      mixed-precision search's feasibility constraint).
    """

    init_params: Callable
    feature_dim: Callable
    forward: Callable
    quant_layers: Optional[Callable] = None


@dataclasses.dataclass(frozen=True)
class BuildRecipe:
    """An ordered pass list plus an optional model exporter.

    ``exporter(model, qcfg) -> Graph`` lets ``repro_torch.compile`` accept
    the architecture's native model object (e.g. a ResNet-9 param tree)
    instead of a pre-exported graph.  ``init_params``/``feature_dim``/
    ``forward``/``quant_layers`` are the FSL backbone hooks that
    :meth:`workload_hooks` assembles into an :class:`FSLHooks`; ``hooks``
    maps any other workload kind to its bundle.
    """

    name: str
    passes: Tuple[str, ...]
    description: str = ""
    exporter: Optional[Callable] = None
    init_params: Optional[Callable] = None
    feature_dim: Optional[Callable] = None
    forward: Optional[Callable] = None
    quant_layers: Optional[Callable] = None
    # (kind, hooks-object) pairs: a tuple, not a dict, to keep the
    # dataclass frozen and hashable
    hooks: Tuple[Tuple[str, Any], ...] = ()

    def hook_kinds(self) -> Tuple[str, ...]:
        """Workload kinds this recipe can drive."""
        kinds = {k for k, _ in self.hooks}
        if not any(getattr(self, h) is None
                   for h in ("init_params", "feature_dim", "forward")):
            kinds.add("fsl")
        return tuple(sorted(kinds))

    def workload_hooks(self, kind: str) -> Any:
        """Resolve the hook bundle for one workload kind, failing loudly —
        the wrong-arch failure mode is a silent wrong-shaped restore, so the
        check happens up front, by name."""
        table = dict(self.hooks)
        if kind in table:
            return table[kind]
        if kind == "fsl":
            missing = [h for h in ("init_params", "feature_dim", "forward")
                       if getattr(self, h) is None]
            if not missing:
                return FSLHooks(init_params=self.init_params,
                                feature_dim=self.feature_dim,
                                forward=self.forward,
                                quant_layers=self.quant_layers)
            raise ValueError(
                f"recipe '{self.name}' has no FSL hooks {missing}; register "
                "it with init_params/feature_dim/forward to use it with "
                "FSLPipeline")
        raise ValueError(
            f"recipe '{self.name}' has no workload hooks for kind {kind!r}; "
            f"available kinds: {list(self.hook_kinds())}")

    def require_fsl_hooks(self) -> "BuildRecipe":
        """The reference's deprecated spelling of ``workload_hooks("fsl")``:
        warns, fails loudly on a recipe without FSL hooks, returns
        ``self``."""
        warnings.warn(
            "BuildRecipe.require_fsl_hooks() is deprecated; use "
            "workload_hooks('fsl')", DeprecationWarning, stacklevel=2)
        self.workload_hooks("fsl")
        return self


_RECIPES: Dict[str, BuildRecipe] = {}

# name -> module that registers it on import: keeps ``recipe("resnet9")``
# working without eagerly importing model code.
_LAZY: Dict[str, str] = {"resnet9": "repro_torch.models.resnet9",
                         "lm-decode": "repro_torch.models.lm"}


def register_recipe(name: str, passes: Sequence[str], *,
                    description: str = "",
                    exporter: Optional[Callable] = None,
                    init_params: Optional[Callable] = None,
                    feature_dim: Optional[Callable] = None,
                    forward: Optional[Callable] = None,
                    quant_layers: Optional[Callable] = None,
                    hooks: Optional[Mapping[str, Any]] = None) -> BuildRecipe:
    for p in passes:
        if isinstance(p, str) and p not in P.PASS_REGISTRY:
            raise KeyError(f"recipe '{name}' references unknown pass '{p}'; "
                           f"registered: {sorted(P.PASS_REGISTRY)}")
    r = BuildRecipe(name, tuple(passes), description, exporter,
                    init_params=init_params, feature_dim=feature_dim,
                    forward=forward, quant_layers=quant_layers,
                    hooks=tuple(sorted((hooks or {}).items())))
    _RECIPES[name] = r
    return r


def register_lazy_recipe(name: str, module: str) -> None:
    """Point a recipe name at the module whose import registers it."""
    _LAZY[name] = module


def recipe(name: str) -> BuildRecipe:
    if name not in _RECIPES and name in _LAZY:
        importlib.import_module(_LAZY[name])
    if name not in _RECIPES:
        raise KeyError(f"unknown recipe '{name}'; registered: "
                       f"{sorted(set(_RECIPES) | set(_LAZY))}")
    return _RECIPES[name]


def list_recipes() -> Dict[str, str]:
    """``{name: description}`` of every recipe, lazy ones imported."""
    for name, module in list(_LAZY.items()):
        if name not in _RECIPES:
            try:
                importlib.import_module(module)
            except ImportError:
                pass
    return {name: r.description for name, r in sorted(_RECIPES.items())}


# The FINN tutorial flow for a plain MLP: no layout juggling, no spatial
# reductions — streamline scales, fuse MVAUs, done.  Owned by core because it
# is the reference/baseline recipe the paper contrasts against.
register_recipe(
    "mlp",
    ["move_mul_past_matmul",
     "collapse_repeated_mul",
     "fold_mul_into_multithreshold",
     "fuse_matmul_threshold_to_mvau",
     "verify_hw_mappable"],
    description="FINN tutorial MLP flow (paper Sec. III-A baseline)")
