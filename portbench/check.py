"""The comparison that decides ``correct``: what the timed path produced,
against the plain reference on the same parameters and frames.

Each number compared has its own limit and passes when it is at or under
it. The numbers are worked out by the same code whether the answers come
from the program or from the control (the reference at a lower precision
put in the program's place).
"""

from __future__ import annotations

from typing import Dict, NamedTuple

import torch


class Number(NamedTuple):
    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return self.value <= self.limit


def feature_mismatch(got: Dict[int, torch.Tensor],
                     want: Dict[int, torch.Tensor], limits: Dict) -> Number:
    """Feature elements of the checked calls that differ from the
    reference's (the grid model is exact, so the limit is 0)."""
    bad = sum(int((got[i].to(torch.float64) != want[i].to(got[i].device))
                  .sum()) for i in got)
    return Number("feature_mismatch", float(bad),
                  float(limits["feature_mismatch"]))
