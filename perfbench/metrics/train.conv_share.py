"""Share of the traced steps' device time in convolutions, forward and
backward, in %: the operations launched by a convolution operator."""
from perfbench.metrics._common import seconds


def read(run):
    if run.summary is None or not run.summary.ops:
        return None
    conv = [o for o in run.summary.ops
            if o.op and ("convolution" in o.op or "conv2d" in o.op)]
    total = seconds(run.summary.ops)
    return 100.0 * seconds(conv) / total if total else None
