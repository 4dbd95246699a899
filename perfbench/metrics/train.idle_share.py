"""Share of the traced steps' window in which no operation ran on the
device, in %."""
from perfbench.metrics._common import idle_share


def read(run):
    return idle_share(run)
