"""Sharding-tree construction of the port: parameter/optimizer/batch/cache
trees of layouts over a mesh of ranks, and the serving mesh.

Counterpart of the JAX package's ``dist/sharding.py``, branch for branch.
A layout is a :class:`NamedSharding`: a mesh (a
``torch.distributed.device_mesh.DeviceMesh`` over the ranks of an
initialized process group, or a bare ``{axis: size}`` mapping where only
the rule is wanted) and a spec, a tuple with one entry per tensor dim:
``None``, a mesh axis name, or a tuple of names.  :attr:`NamedSharding.placements`
turns the spec into DTensor placements; DTensor's sharding propagation
then stands where GSPMD stands in the reference.

Policy (shape-driven, path-free):

* **Params** (ndim >= 2): the trailing (output-feature) dim shards over the
  ``"model"`` axis; the second-to-last (input-feature) dim over the FSDP
  axes; 3-D+ leaves also shard their leading dim over the expert axis.  A
  dim shards only when its size divides the axes' size, and a mesh axis is
  never used twice in one spec; otherwise the dim stays replicated.
* **Opt moments**: the params' layouts (ZeRO-1).
* **Batch**: dim 1 of pre-microbatched ``(n_micro, mb, ...)`` tensors, dim
  0 of serving ``(B, ...)`` tensors, over ``("pod", "data")`` (or
  ``"data"`` alone when the pair does not divide).
* **Cache**: the batch dim (dim 1, after the layer axis) over the data
  axes.

The rules read only the mesh's axis sizes, so they work as well on a
512-rank fake group as on a real one.  :func:`serve_mesh` returns ``None``
for one device or fewer (the serial NCM head) and a 1-D ``("model",)``
mesh over the group's ranks for more; it never starts a group.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Mapping, Optional, Sequence, Tuple, Union

from repro_torch.tree import tree_map

__all__ = [
    "NamedSharding",
    "RowSplit",
    "mesh_shape",
    "moe_expert_axis",
    "prototype_spec",
    "serve_mesh",
    "set_fsdp_axes",
    "set_moe_expert_axis",
    "tree_param_shardings",
    "tree_opt_shardings",
    "tree_batch_shardings",
    "tree_cache_shardings",
]

Spec = Tuple[Union[None, str, Tuple[str, ...]], ...]

# Policy knobs, set by the launcher before building layouts (see
# launch/dryrun.py): which mesh axes FSDP-shard the input-feature dim, and
# which axis is "home" for MoE expert banks.
_FSDP_AXES: Tuple[str, ...] = ("data",)
_EXPERT_AXIS: str = "data"


def set_fsdp_axes(axes: Sequence[str]) -> None:
    global _FSDP_AXES
    _FSDP_AXES = tuple(axes)


def set_moe_expert_axis(axis: str) -> None:
    global _EXPERT_AXIS
    _EXPERT_AXIS = axis


def moe_expert_axis() -> str:
    """The mesh axis that is "home" for MoE experts (the axis
    :func:`set_moe_expert_axis` set): the expert banks' leading dim and
    the MoE dispatch buffer shard over it."""
    return _EXPERT_AXIS


def mesh_shape(mesh: Any) -> Dict[str, int]:
    """``{axis name: size}`` of a ``DeviceMesh`` or of a mapping."""
    if isinstance(mesh, Mapping):
        return dict(mesh)
    return dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A mesh and a spec (one entry per tensor dim: ``None``, an axis name
    or a tuple of names), the port's ``NamedSharding(mesh,
    PartitionSpec(*spec))``."""

    mesh: Any
    spec: Spec

    @property
    def placements(self) -> tuple:
        """DTensor placements, one per mesh axis: ``Shard(d)`` where the
        spec puts that axis on tensor dim ``d`` (one dim over two axes is
        ``Shard(d)`` on both, in mesh order), else ``Replicate()``."""
        from torch.distributed.tensor import Replicate, Shard

        where: Dict[str, int] = {}
        for d, entry in enumerate(self.spec):
            for name in (entry if isinstance(entry, tuple)
                         else () if entry is None else (entry,)):
                where[name] = d
        return tuple(Shard(where[a]) if a in where else Replicate()
                     for a in mesh_shape(self.mesh))

    def place(self, t):
        """``t`` (the same full tensor on every rank) as a DTensor of this
        layout: each rank keeps its own chunk, no communication."""
        from torch.distributed.tensor import distribute_tensor

        return distribute_tensor(t, self.mesh, self.placements,
                                 src_data_rank=None)


def _axes_size(shape: Dict[str, int], axes: Tuple[str, ...]) -> int:
    return math.prod(shape[a] for a in axes)


def _present(shape: Dict[str, int], axes: Sequence[str]) -> Tuple[str, ...]:
    return tuple(a for a in axes if a in shape)


def _shape_of(leaf: Any) -> Tuple[int, ...]:
    return tuple(getattr(leaf, "shape", ()) or ())


def _param_spec(shape: Tuple[int, ...], mesh: Any) -> Spec:
    ms = mesh_shape(mesh)
    ndim = len(shape)
    spec: list = [None] * ndim
    used: set = set()

    def try_assign(dim: int, axes: Tuple[str, ...]) -> None:
        axes = tuple(a for a in axes if a not in used)
        if not axes or spec[dim] is not None:
            return
        if shape[dim] % _axes_size(ms, axes) != 0 or shape[dim] == 0:
            return
        spec[dim] = axes if len(axes) > 1 else axes[0]
        used.update(axes)

    if ndim >= 2:
        try_assign(ndim - 1, _present(ms, ("model",)))
        try_assign(ndim - 2, _present(ms, _FSDP_AXES))
    if ndim >= 3:
        try_assign(0, _present(ms, (_EXPERT_AXIS,)))
    return tuple(spec)


def tree_param_shardings(params: Any, mesh: Any) -> Any:
    """Layout tree mirroring a parameter tree (TP + FSDP)."""
    return tree_map(
        lambda p: NamedSharding(mesh, _param_spec(_shape_of(p), mesh)),
        params)


def tree_opt_shardings(params: Any, mesh: Any) -> Any:
    """Moment layouts: co-located with the params they track (ZeRO-1)."""
    return tree_param_shardings(params, mesh)


def _data_spec(shape: Tuple[int, ...], mesh: Any, dim: int) -> Spec:
    ms = mesh_shape(mesh)
    data_axes = _present(ms, ("pod", "data"))
    for axes in (data_axes, data_axes[-1:]):
        if shape[dim] > 0 and shape[dim] % _axes_size(ms, axes) == 0:
            spec: list = [None] * len(shape)
            spec[dim] = axes if len(axes) > 1 else axes[0]
            return tuple(spec)
    return ()


def _batch_spec(shape: Tuple[int, ...], mesh: Any) -> Spec:
    if not _present(mesh_shape(mesh), ("pod", "data")) or not shape:
        return ()
    # pre-microbatched (n_micro, mb, ...) shards mb; serving (B, ...) shards B
    return _data_spec(shape, mesh, 1 if len(shape) >= 3 else 0)


def tree_batch_shardings(batch: Any, mesh: Any) -> Any:
    """Data-parallel layouts for a batch tree."""
    return tree_map(
        lambda b: NamedSharding(mesh, _batch_spec(_shape_of(b), mesh)), batch)


def _cache_spec(shape: Tuple[int, ...], mesh: Any) -> Spec:
    # leaves carry a leading layer axis: (L, B, ...); "len" counters are (L,)
    if len(shape) < 2 or not _present(mesh_shape(mesh), ("pod", "data")):
        return ()
    return _data_spec(shape, mesh, 1)


def tree_cache_shardings(cache: Any, mesh: Any) -> Any:
    """Decode-cache layouts: the batch dim (after the layer axis) over data."""
    return tree_map(
        lambda c: NamedSharding(mesh, _cache_spec(_shape_of(c), mesh)), cache)


def serve_mesh(devices: Optional[Sequence[Any]] = None,
               axis: str = "model") -> Optional[Any]:
    """1-D ``(axis,)`` mesh over the ranks of the initialized process group
    for the serving-side NCM head, or ``None`` for one device or fewer:
    the serial head.

    ``devices`` lists one device (or rank) per rank; its length must be
    the group's world size.  ``None`` means every rank of the group (one,
    with no group).  The mesh's device type is the devices' (``"cuda:0"``
    gives ``cuda``; ranks or nothing give ``cuda`` where a card exists).
    The caller starts the group; this function never does.
    """
    import torch
    import torch.distributed as dist

    if devices is None:
        n = dist.get_world_size() if dist.is_initialized() else 1
        first = None
    else:
        devices = list(devices)
        n, first = len(devices), (devices[0] if devices else None)
    if n <= 1:
        return None
    if not dist.is_initialized() or dist.get_world_size() != n:
        have = dist.get_world_size() if dist.is_initialized() else 0
        raise RuntimeError(
            f"a serving mesh over {n} devices needs an initialized process "
            f"group of {n} ranks (have {have}); the caller starts it "
            "(torch.distributed.init_process_group)")
    if isinstance(first, (str, torch.device)):
        dev_type = torch.device(first).type
    else:
        dev_type = "cuda" if torch.cuda.is_available() else "cpu"
    from torch.distributed.device_mesh import init_device_mesh

    return init_device_mesh(dev_type, (n,), mesh_dim_names=(axis,))


@dataclasses.dataclass(frozen=True)
class RowSplit:
    """How a (C, D) prototype matrix lies over ``n_dev`` devices: its class
    rows split in ``n_dev`` equal blocks along ``axis`` (``split``), or
    replicated on every device."""

    axis: str
    n_dev: int
    split: bool


def prototype_spec(n_rows: int, mesh: Any, axis: str = "model") -> RowSplit:
    """The row split of a (``n_rows``, D) prototype matrix over ``mesh``
    (a mesh with ``axis``, or the device count itself): rows split over
    ``axis`` when their count divides its size, else replicated — the
    reference's divisibility-or-replicate rule (callers pad C up to a
    multiple to get the split case)."""
    if isinstance(mesh, int):
        n_dev, present = mesh, True
    else:
        shape = mesh_shape(mesh)
        n_dev, present = shape.get(axis, 1), axis in shape
    return RowSplit(axis, int(n_dev),
                    present and n_dev > 0 and n_rows > 0
                    and n_rows % n_dev == 0)
