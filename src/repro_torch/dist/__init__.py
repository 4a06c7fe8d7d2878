"""Distribution substrate of the port, on ``torch.distributed``.

Counterpart of the JAX package's ``repro.dist``.  Layouts are a
``DeviceMesh`` of ranks plus DTensor placements; DTensor's sharding
propagation stands where GSPMD stands in the reference.  Nothing here
starts a process group: the caller does (tests, ``chip_smoke.py``, the
launchers).  On plain tensors (one device) every layout is the one tensor
and nothing changes numerics.

* :mod:`~repro_torch.dist.act_sharding` — named activation-sharding
  constraint points; ``constrain`` redistributes a DTensor to the bound
  rule, the identity on plain tensors.
* :mod:`~repro_torch.dist.sharding` — the parameter/optimizer/batch/cache
  layout trees (``tree_*_shardings``, ``set_fsdp_axes``,
  ``set_moe_expert_axis``), ``serve_mesh`` and ``prototype_spec``.
* :mod:`~repro_torch.dist.dtensor` — the ops handled by hand on DTensors.
* :mod:`~repro_torch.dist.pipeline` — GPipe over a mesh axis of ranks.
* :mod:`~repro_torch.dist.compression` — int8 gradient compression with
  error feedback, the train step's ``compress_pod_grads``.
* :mod:`~repro_torch.dist.straggler` — ``StragglerMonitor``, the
  launcher's straggler policy.
"""

from repro_torch.dist import act_sharding  # noqa: F401
from repro_torch.dist.compression import (  # noqa: F401
    compress_int8,
    decompress_int8,
    ef_compress_tree,
    init_residuals,
)
from repro_torch.dist.sharding import (  # noqa: F401
    NamedSharding,
    RowSplit,
    prototype_spec,
    serve_mesh,
    set_fsdp_axes,
    set_moe_expert_axis,
    tree_batch_shardings,
    tree_cache_shardings,
    tree_opt_shardings,
    tree_param_shardings,
)
from repro_torch.dist.straggler import StragglerMonitor  # noqa: F401
