"""Production and debug meshes of the port: meshes of ranks.

Counterpart of the JAX package's ``launch/mesh.py``.  A mesh here is a
``DeviceMesh`` over the ranks of the process group the caller has already
started (one H100 per rank on a real group, none on a ``"fake"`` one), not
a mesh of TPU chips.  FUNCTIONS, not module-level constants: importing this
module touches no device and no group.
"""

from __future__ import annotations

from typing import Optional


def _device_type(device_type: Optional[str]) -> str:
    if device_type:
        return device_type
    import torch.distributed as dist

    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: Optional[str] = None):
    """16×16 = 256 ranks (``("data", "model")``); multi-pod adds a leading
    2-pod axis (512 ranks, ``("pod", "data", "model")``).  The group must
    hold exactly that many ranks."""
    from torch.distributed.device_mesh import init_device_mesh

    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return init_device_mesh(_device_type(device_type), shape,
                            mesh_dim_names=axes)


def make_debug_mesh(n_data: int = 2, n_model: int = 2,
                    device_type: Optional[str] = None):
    """Small ``("data", "model")`` mesh over ``n_data * n_model`` ranks."""
    from torch.distributed.device_mesh import init_device_mesh

    return init_device_mesh(_device_type(device_type), (n_data, n_model),
                            mesh_dim_names=("data", "model"))
