"""Distribution substrate of the port: the serial halves.

Counterpart of the JAX package's ``repro.dist``.  The serial halves the
serving cluster and the one-card train step need:

* :mod:`~repro_torch.dist.act_sharding` — named activation-sharding
  constraint points; ``constrain`` is the identity (one device, one
  layout).
* :mod:`~repro_torch.dist.sharding` — ``serve_mesh`` (``None`` on one
  device, the signal to take the serial path) and ``prototype_spec``
  (class rows split when their count divides the devices, else
  replicated).
* :mod:`~repro_torch.dist.compression` — int8 gradient compression with
  error feedback, the train step's ``compress_pod_grads``.
* :mod:`~repro_torch.dist.straggler` — ``StragglerMonitor``, the
  launcher's straggler policy.

The parameter/batch/optimizer/cache sharding trees and pipeline
parallelism are not ported yet.
"""

from repro_torch.dist import act_sharding  # noqa: F401
from repro_torch.dist.sharding import (  # noqa: F401
    RowSplit,
    prototype_spec,
    serve_mesh,
)
