"""Named activation-sharding constraint points.

Counterpart of the JAX package's ``dist/act_sharding.py``.  Code marks
semantically meaningful tensors (``constrain(q, "serve/query_rows")``)
without knowing anything about devices; a caller binds names to rules for
the duration of a block (``with act_sharding.rules({...}): ...``).  The
port runs on one card, where every layout is the one tensor, so
:func:`constrain` returns its input whatever rule is bound: a layout hint
never changes numerics.  The rule map is thread-local, as the reference's.
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
    """The tensor ``x`` itself: on one device a bound rule has no layout to
    pick.  (The reference applies ``with_sharding_constraint`` when a rule
    is bound; on one device that too is the identity.)"""
    return x
