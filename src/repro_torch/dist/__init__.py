"""Distribution substrate of the port: the serial halves.

Counterpart of the JAX package's ``repro.dist``.  This slice ports what the
serving cluster needs on one card:

* :mod:`~repro_torch.dist.act_sharding` — named activation-sharding
  constraint points; ``constrain`` is the identity (one device, one
  layout).
* :mod:`~repro_torch.dist.sharding` — ``serve_mesh`` (``None`` on one
  device, the signal to take the serial path) and ``prototype_spec``
  (class rows split when their count divides the devices, else
  replicated).

The parameter/batch/optimizer/cache sharding trees, gradient compression,
the straggler policy and pipeline parallelism are not ported yet.
"""

from repro_torch.dist import act_sharding  # noqa: F401
from repro_torch.dist.sharding import (  # noqa: F401
    RowSplit,
    prototype_spec,
    serve_mesh,
)
