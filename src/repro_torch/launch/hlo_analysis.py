"""Deprecated shim — the analysis lives in :mod:`repro_torch.obs.hlo`.

Kept so ``from repro_torch.launch import hlo_analysis`` and
``hlo_analysis.analyze(...)`` work as the reference's shim does; new code
imports :mod:`repro_torch.obs.hlo` directly.
"""

from repro_torch.obs.hlo import (  # noqa: F401
    _COLLECTIVES,
    DispatchRecord,
    Event,
    analyze,
    top_collectives,
    top_dots,
)
