"""The operations of every frame delivered in the window (the reference
render's count, ``flops.render_line``, for each request's own length:
padding left out), over the window and the card's bfloat16 peak, in %."""
from perfbench import roofline


def read(run):
    done = run.facts.get("flops_delivered")
    if not done or not run.window_s:
        return None
    return 100.0 * done / (run.window_s * roofline.BF16_FLOPS)
