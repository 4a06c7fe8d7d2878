"""Named activation-sharding constraint points.

Counterpart of the JAX package's ``dist/act_sharding.py``.  Code marks
semantically meaningful tensors (``constrain(q, "serve/query_rows")``)
without knowing anything about meshes; a caller binds names to rules (a
:class:`~repro_torch.dist.sharding.NamedSharding`) for the duration of a
block (``with act_sharding.rules({...}): ...``).  :func:`constrain` is the
port's ``with_sharding_constraint``: a DTensor is redistributed to the
bound rule's placements; a plain tensor (one device, one layout) comes
back as it is, whatever rule is bound.  The rule map is thread-local, as
the reference's.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Any, Dict, Iterator, Optional

_state = threading.local()


def _current() -> Dict[str, object]:
    return getattr(_state, "rules", None) or {}


@contextlib.contextmanager
def rules(rule_map: Dict[str, object]) -> Iterator[None]:
    """Bind ``name -> rule`` for the enclosed block (merged over any rules
    bound outside it; restored on exit)."""
    prev = getattr(_state, "rules", None)
    merged = dict(prev or {})
    merged.update(rule_map)
    _state.rules = merged
    try:
        yield
    finally:
        _state.rules = prev


def get_rule(name: str) -> Optional[object]:
    return _current().get(name)


def constrain(x: Any, name: str) -> Any:
    """Apply the rule bound to ``name`` to a DTensor ``x`` (redistribute
    it to the rule's placements); the identity for a plain tensor or an
    unbound name.  A rule whose spec rank exceeds the tensor rank is
    skipped, as in the reference: one constraint point serves paths of
    different ranks, and a layout hint never breaks numerics."""
    rule = _current().get(name)
    if rule is None:
        return x
    from repro_torch.dist.dtensor import is_dtensor

    if not is_dtensor(x):
        return x
    spec = getattr(rule, "spec", None)
    if spec is not None and len(spec) > x.ndim:
        return x
    placements = tuple(rule.placements)
    if placements == tuple(x.placements):
        return x
    return x.redistribute(rule.mesh, placements)
