"""Design-space exploration over bit-width configurations (paper Tables
II/III) on the card: train each candidate, compile it through both
datapaths, measure episode accuracy / storage bytes / throughput, and emit
the frontier.

``sweep`` is the serial loop; ``SweepFarm`` the parallel, resumable
orchestrator over the same per-candidate unit (``run_candidate``, of which
``run_point`` is the uniform-grid alias); ``publish_frontier`` pushes the
Pareto set into a live serve registry; ``search`` drives the per-layer
mixed-precision successive-halving search over the farm.
"""

from repro_torch.explore.farm import (  # noqa: F401
    FarmResult,
    SweepFarm,
    publish_frontier,
    select_knee,
)
from repro_torch.explore.search import (  # noqa: F401
    SearchResult,
    crossover_plans,
    mutate_plan,
    random_plan,
    search,
)
from repro_torch.explore.sweep import (  # noqa: F401
    DEFAULT_GRID,
    DETERMINISTIC_KEYS,
    Candidate,
    PointResult,
    as_candidate,
    candidate_config,
    candidate_content,
    candidate_label,
    candidate_seed,
    config_for,
    pareto_frontier,
    point_seed,
    probe_batch,
    run_candidate,
    run_point,
    sweep,
)

__all__ = [
    "Candidate", "DEFAULT_GRID", "DETERMINISTIC_KEYS", "FarmResult",
    "PointResult", "SearchResult", "SweepFarm", "as_candidate",
    "candidate_config", "candidate_content", "candidate_label",
    "candidate_seed", "config_for", "crossover_plans", "mutate_plan",
    "pareto_frontier", "point_seed", "probe_batch", "publish_frontier",
    "random_plan", "run_candidate", "run_point", "search", "select_knee",
    "sweep",
]
