"""FINN-style build-step pipelines (paper Sec. III-A) — legacy surface.

Counterpart of the JAX package's ``core/build.py``, list for list.

.. deprecated::
    This module is the thin compatibility shim over the real compiler API:
    :mod:`repro_torch.core.passes` (PassManager + named-pass registry),
    :mod:`repro_torch.core.recipes` (per-architecture ``BuildRecipe``), and
    :func:`repro_torch.compile` (the ``DeployedModel`` artifact).  The step
    lists below are kept so existing call sites and the paper-failure repro
    keep working; new code should use
    ``repro_torch.compile(graph, qcfg, recipe="resnet9")`` or
    ``PassManager().run(graph, recipe("resnet9").passes)``.

FINN drives hardware generation through an ordered list of transformation
steps.  The paper's point is that this list is *architecture-dependent*: the
tutorial MLP steps do not transfer to ResNet-9, which needs (1) the
transpose-absorption fix and (2) the ReduceMean→GAP conversion, inserted in
the right order.  Running ``DEFAULT_MLP_STEPS`` on the ResNet-9 graph fails
*loudly at the mis-ordered pass* (PassOrderError precondition check)
instead of building a silently broken design.
"""

from __future__ import annotations

from typing import List, Sequence

from repro_torch.core import transforms as T
from repro_torch.core.graph import Graph
from repro_torch.core.passes import PassManager

__all__ = ["DEFAULT_MLP_STEPS", "RESNET9_BUILD_STEPS", "build_dataflow"]

# The FINN tutorial flow for a plain MLP — see recipes.recipe("mlp").
DEFAULT_MLP_STEPS: List[T.Transform] = [
    T.MoveMulPastMatMul,
    T.CollapseRepeatedMul,
    T.FoldMulIntoMultiThreshold,
    T.FuseMatMulThresholdToMVAU,
    T.VerifyHWMappable,
]

# The paper's customized ResNet-9 flow — see recipes.recipe("resnet9")
# (registered by repro_torch.models.resnet9 next to its export code).
RESNET9_BUILD_STEPS: List[T.Transform] = [
    T.ConvertReduceMeanToGAP,
    T.AbsorbTransposeIntoMultiThreshold,
    T.CancelTransposePairs,
    T.MoveMulPastMatMul,
    T.CollapseRepeatedMul,
    T.FoldMulIntoMultiThreshold,
    T.FuseMatMulThresholdToMVAU,
    T.VerifyHWMappable,
]


def build_dataflow(graph: Graph, steps: Sequence[T.Transform]) -> Graph:
    """Apply a build-step list; returns the HW-ready graph or raises
    :class:`~repro_torch.core.graph.GraphBuildError`.

    Deprecated shim: delegates to the PassManager, so raw transform
    functions are resolved to their registered passes and get precondition
    checking and ordering validation for free.
    """
    return PassManager().run(graph, steps).graph
