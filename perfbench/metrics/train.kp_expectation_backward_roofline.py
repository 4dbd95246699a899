"""K3b (``csrc/kp_expectation.cu``) in the traced steps: the least time
its calls could take (``roofline.kp_expectation_backward`` of each call's
shapes) over the device time of what the calls launched, in %."""
from perfbench import roofline
from perfbench.metrics._common import operator_calls, seconds


def read(run):
    bound = took = 0.0
    for shapes, dtypes, _, ops in operator_calls(
            run, "eamm::kp_expectation_backward"):
        if shapes and dtypes and ops:
            bound += roofline.kp_expectation_backward(shapes, dtypes)
            took += seconds(ops)
    return 100.0 * bound / took if took else None
