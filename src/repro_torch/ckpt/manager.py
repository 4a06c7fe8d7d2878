"""Checkpoints: monotone train steps and content-addressed named entries.

Counterpart of the JAX package's ``ckpt/manager.py``, in its on-disk
format: one directory per entry holding ``arrays.npz`` (one array per
leaf, keyed by its path, ``r1a/w``, as :func:`repro_torch.tree.tree_paths`
gives it) and ``meta.json``.  A checkpoint written by either package
restores in the other.

* **Atomicity**: each entry is staged in a private ``tmp.<tag>.*``
  directory and published with ``os.replace``; a crash mid-write never
  leaves a half entry, and two writers of the same key each publish a
  complete one (the last replace wins).
* **Keep-k GC** on ``step_*`` entries; named entries (``save_named``,
  typically under :func:`content_key` of the configuration that produced
  them: the DSE farm's resume cache) are never collected.
* ``restore(like)`` rebuilds the structure of ``like``: a tensor leaf of
  ``like`` comes back as a tensor on that leaf's device, any other leaf as
  the stored numpy array.
"""

from __future__ import annotations

import hashlib
import json
import os
import re
import shutil
import tempfile
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from repro_torch.convert import params_to_numpy
from repro_torch.models.layers import not_ported
from repro_torch.tree import tree_flatten, tree_paths

__all__ = ["CheckpointManager", "content_key", "restore_resharded"]


def content_key(config: Any, length: int = 16) -> str:
    """Deterministic content hash of a JSON-able configuration: canonical
    JSON (sorted keys, no whitespace) through sha256, truncated to
    ``length`` hex chars.  Stable across processes and platforms, and the
    same string as the reference's for the same configuration."""
    blob = json.dumps(config, sort_keys=True, separators=(",", ":"),
                      default=str)
    return hashlib.sha256(blob.encode()).hexdigest()[:length]


_NAME_RE = re.compile(r"^[A-Za-z0-9._-]+$")


def _flatten(tree: Any) -> Dict[str, np.ndarray]:
    leaves, _ = tree_flatten(params_to_numpy(tree))
    return dict(zip(tree_paths(tree), leaves))


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3):
        self.dir = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)

    # -- write --------------------------------------------------------------
    def _publish(self, tag: str, final: str, tree: Any, meta: Dict) -> str:
        """Write arrays + meta to a private ``tmp.<tag>.*`` dir, then
        ``os.replace`` it into ``final``.  The staging dir is
        mkdtemp-unique, so two concurrent writers of one key never
        interleave; the bounded retry covers a concurrent writer that
        re-creates ``final`` between our rmtree and replace."""
        flat = _flatten(tree)
        tmp = tempfile.mkdtemp(prefix=f"tmp.{tag}.", dir=self.dir)
        np.savez(os.path.join(tmp, "arrays.npz"), **flat)
        with open(os.path.join(tmp, "meta.json"), "w") as f:
            json.dump(meta, f)
        for attempt in range(10):
            if os.path.exists(final):
                shutil.rmtree(final, ignore_errors=True)
            try:
                os.replace(tmp, final)
                return final
            except OSError:
                if attempt == 9:
                    raise
        return final

    def save(self, step: int, tree: Any, meta: Optional[Dict] = None) -> str:
        final = self._publish(str(step),
                              os.path.join(self.dir, f"step_{step:010d}"),
                              tree, {"step": step, **(meta or {})})
        self._gc()
        return final

    # -- content-addressed entries (never GC'd) -----------------------------
    def _named_dir(self, name: str) -> str:
        if not _NAME_RE.match(name):
            raise ValueError(
                f"invalid checkpoint name {name!r}: use [A-Za-z0-9._-] "
                "(content_key() output is always valid)")
        return os.path.join(self.dir, f"named_{name}")

    def save_named(self, name: str, tree: Any,
                   meta: Optional[Dict] = None) -> str:
        """Atomically store ``tree`` under an arbitrary key; overwrites an
        existing entry of the same name."""
        return self._publish(f"named_{name}", self._named_dir(name), tree,
                             {"name": name, **(meta or {})})

    def has_named(self, name: str) -> bool:
        return os.path.isdir(self._named_dir(name))

    def all_named(self) -> List[str]:
        return sorted(n[len("named_"):] for n in os.listdir(self.dir)
                      if n.startswith("named_"))

    def restore_named(self, like: Any, name: str) -> Any:
        if not self.has_named(name):
            raise FileNotFoundError(
                f"no named checkpoint '{name}' under {self.dir}")
        return self._read(self._named_dir(name), like)

    def named_meta(self, name: str) -> Dict:
        with open(os.path.join(self._named_dir(name), "meta.json")) as f:
            return json.load(f)

    def _gc(self):
        steps = self.all_steps()
        for s in steps[:-self.keep] if self.keep else []:
            shutil.rmtree(os.path.join(self.dir, f"step_{s:010d}"),
                          ignore_errors=True)

    # -- read ---------------------------------------------------------------
    def all_steps(self):
        return sorted(int(n.split("_")[1]) for n in os.listdir(self.dir)
                      if n.startswith("step_"))

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def _read(self, path: str, like: Any) -> Any:
        leaves_like, unflatten = tree_flatten(like)
        with np.load(os.path.join(path, "arrays.npz")) as data:
            leaves = []
            for key, ref in zip(tree_paths(like), leaves_like):
                if key not in data:
                    raise KeyError(f"checkpoint missing leaf '{key}' "
                                   "(tree structure changed?)")
                arr = data[key]
                leaves.append(torch.as_tensor(arr, device=ref.device)
                              if isinstance(ref, torch.Tensor) else arr)
        return unflatten(leaves)

    def restore(self, like: Any, step: Optional[int] = None) -> Any:
        """Restore into the structure of ``like``."""
        step = self.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {self.dir}")
        return self._read(os.path.join(self.dir, f"step_{step:010d}"), like)

    def meta(self, step: Optional[int] = None) -> Dict:
        step = self.latest_step() if step is None else step
        with open(os.path.join(self.dir, f"step_{step:010d}",
                               "meta.json")) as f:
            return json.load(f)


def restore_resharded(mgr: CheckpointManager, like: Any,
                      sharding_fn: Callable[[str, tuple], Any],
                      step: Optional[int] = None) -> Any:
    """Restore + re-place each leaf under a new mesh's sharding: waits for
    the cluster and distribution slice of the port."""
    raise not_ported("restore_resharded (elastic resharding)",
                     "cluster, distribution and scale")
