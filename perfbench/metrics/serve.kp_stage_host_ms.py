"""Host milliseconds a dispatch spends inside the pipeline's batch
keypoint call (the harness's span around ``_batch_kp_impl``), the mean
over the window's dispatches outside the traced ones.  The stage is
launch-bound: this is the time the card is fed."""


def read(run):
    times = [s for s, tag in zip(run.spans.seconds.get("kp_stage", []),
                                 run.spans.tags.get("kp_stage", []))
             if tag == "window"]
    return 1e3 * sum(times) / len(times) if times else None
