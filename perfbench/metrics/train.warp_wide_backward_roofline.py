"""K1b (``csrc/warp_backward.cu``: binning, scan, placement and the
gathers) in the traced steps: the least time its calls could take
(``roofline.warp_backward`` of each call's shapes and the gradients it
was asked for) over the device time of what the calls launched, in %."""
from perfbench import roofline
from perfbench.metrics._common import operator_calls, seconds


def read(run):
    bound = took = 0.0
    for shapes, dtypes, concrete, ops in operator_calls(
            run, "eamm::warp_wide_backward"):
        if shapes and dtypes and concrete and ops:
            bound += roofline.warp_backward(shapes, dtypes, bool(concrete[4]),
                                            bool(concrete[5]))
            took += seconds(ops)
    return 100.0 * bound / took if took else None
