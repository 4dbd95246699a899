"""The window's steps times a step's operations (forward and backward,
``flops.train_step`` over the reference at the cell's shapes), over the
window and the card's float32 peak (TF32 off), in %."""
from perfbench import roofline


def read(run):
    steps, flops = run.facts.get("steps"), run.facts.get("step_flops")
    if not steps or not flops or not run.window_s:
        return None
    return 100.0 * steps * flops / (run.window_s * roofline.F32_FLOPS)
