"""K1 (``csrc/warp.cu`` ``warp_wide_kernel``) in the traced dispatches:
the least time its calls could take (``roofline.warp_forward`` of each
call's shapes) over the device time of what the calls launched, in %."""
from perfbench import roofline
from perfbench.metrics._common import operator_calls, seconds


def read(run):
    bound = took = 0.0
    for shapes, dtypes, _, ops in operator_calls(run, "eamm::warp_wide"):
        if shapes and dtypes and ops:
            bound += roofline.warp_forward(shapes, dtypes)
            took += seconds(ops)
    return 100.0 * bound / took if took else None
