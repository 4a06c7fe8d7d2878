"""Share of the traced stretch in which no kernel or copy ran on the card,
in %: one minus the union of the device's intervals over the stretch."""

from portbench.trace import idle_share


def read(r):
    return idle_share(getattr(r, "trace", None))
