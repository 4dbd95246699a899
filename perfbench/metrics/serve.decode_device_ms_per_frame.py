"""Device milliseconds of the operations launched inside the decode
ranges (the harness's span around the pipeline's batch segment call),
over the frames those calls decoded, padding included, in the traced
dispatches."""
from perfbench.metrics._common import seconds


def read(run):
    frames = run.facts.get("traced_decoded_frames")
    if run.summary is None or not frames:
        return None
    ops = [o for o in run.summary.ops if "decode" in o.ranges]
    return 1e3 * seconds(ops) / frames if ops else None
