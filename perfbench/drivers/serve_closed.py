"""Closed-loop serving: ``clients`` threads, each sending its next request
when its last returns, to ``eamm_tpu_torch.serve.RenderServer`` over an
``EammPipeline`` in this process.

Set-up draws the weights on the device, builds the pipeline and the
server with the cell's ``server`` settings, warms every MFCC length the
traffic uses and two full dispatches, starts the clients and lets them
run ``settle_s``.  The window then runs ``--seconds``; a request belongs
to it when its result reaches its client inside it.  ``frames_per_s`` is
the frames of those requests (each trimmed to its own length) over the
window; ``latency_p95_s`` the 95th percentile of their times from
``submit`` to the client holding the result.  After the window the
clients stop sending, the ones in flight are waited for, the peak memory
is read and the program freed; then the reference renders a sample of the
window's requests (the longest among them), and the worst frame's gap
(the mean absolute difference of the ``check.block``-square means of its
yuv420 planes) over the same gap of the reference with its decode in the
configuration's precision is compared with the cell's limit
(``compare``).  Each delivered clip's length is checked too.  The result
carries the window's host readings under ``diag``: the spans' means, how
late the clients woke after their results were handed over, the
process's CPU time and involuntary context switches, and a fixed Python
loop's time before and after the window.

With ``--trace 1`` the profiler runs on the server's worker for the
cell's ``trace.dispatches`` dispatches from ``trace.after_s`` into the
window; the host spans of the other dispatches feed the host metrics.
"""
from __future__ import annotations

import gc
import resource
import threading
import time

import numpy as np
import torch

from perfbench import flops, traffic, weights
from perfbench.reference import nets as R
from perfbench.reference import render as reference
from perfbench.tracing import Trace

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def build_server(run, state_dicts):
    from eamm_tpu_torch import config as C
    from eamm_tpu_torch.infer.pipeline import EammPipeline, PipelineOptions
    from eamm_tpu_torch.serve import RenderServer
    s, cfg = run.cell["server"], run.config
    torch.manual_seed(run.seed)        # the unused emotion net's own draw
    models = C.build_all(cfg)
    for name, sd in state_dicts.items():
        models[name].load_state_dict(sd)
    options = PipelineOptions(
        emo_type="linear_3", add_emo=False,
        audio_weight=cfg["audio_weight"],
        transfer_format=s["transfer_format"],
        overlap_segments=s["overlap_segments"], frame_chunk=s["frame_chunk"],
        time_bucket=s["time_bucket"], segment_frames=s["segment_frames"],
        stream_policy_frames=s["stream_policy_frames"],
        compute_dtype=DTYPES[cfg["precision"]["generator"]],
        device=run.device)
    pipe = EammPipeline(cfg, options=options, models=models)
    return RenderServer(pipe, max_batch=s["max_batch"],
                        max_delay_ms=s["max_delay_ms"])


def instrument(run, server, trace: Trace | None):
    """Spans around the pipeline's batch keypoint and batch segment calls
    and the server's dispatches; with ``trace``, the profiler started and
    stopped on the worker around the chosen dispatches."""
    pipe = server.pipeline
    kp_impl, seg_impl = pipe._batch_kp_impl, pipe._batch_segment_impl
    dispatch = server._dispatch
    tc = run.cell.get("trace", {})
    state = {"traced": 0, "on": False, "tag": None}

    def kp(*a, **k):
        with run.spans("kp_stage", state["tag"]):
            return kp_impl(*a, **k)

    def seg(*a, **k):
        if state["tag"] == "traced":          # frames decoded under the trace
            kv = a[4] if len(a) > 4 else k["kp_value"]
            run.facts["traced_decoded_frames"] = run.facts.get(
                "traced_decoded_frames", 0) + kv.shape[0] * kv.shape[1]
        with run.spans("decode", state["tag"]):
            return seg_impl(*a, **k)

    def disp(group):
        go = (trace is not None and run.window_start is not None
              and state["traced"] < tc.get("dispatches", 4)
              and time.monotonic() >= run.window_start + tc.get("after_s", 5))
        if go and not state["on"]:
            trace.start()
            state["on"] = True
        state["tag"] = ("traced" if state["on"] else "setup"
                        if run.window_start is None else "window")
        try:
            with run.spans("dispatch", state["tag"]):
                return dispatch(group)
        finally:
            if state["on"]:
                state["traced"] += 1
                if state["traced"] >= tc.get("dispatches", 4):
                    trace.stop()
                    state["on"] = False
            state["tag"] = None

    finish = server._finish

    def fin(group, results):
        now = time.monotonic()
        for r in group:               # when the result was handed over
            r.future.finished_at = now
        return finish(group, results)

    pipe._batch_kp_impl, pipe._batch_segment_impl = kp, seg
    server._dispatch, server._finish = disp, fin


def host_probe_ms() -> float:
    """The best of three timings of a fixed pure-Python loop: the host's
    speed for the launch-bound parts, read before and after the window."""
    best = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        x = 0
        for i in range(200_000):
            x += i & 7
        best = min(best, time.perf_counter() - t0)
    return 1e3 * best


def window_means(run, *names) -> dict:
    """{name: mean host ms of the window's spans of ``name``, and
    'dispatches': how many the window had}."""
    out = {}
    for name in names:
        times = [s for s, tag in zip(run.spans.seconds.get(name, []),
                                     run.spans.tags.get(name, []))
                 if tag == "window"]
        out[f"{name}_ms"] = 1e3 * sum(times) / len(times) if times else None
        if name == "dispatch":
            out["dispatches"] = len(times)
    return out


def keep_rule(seed: int, lengths):
    """Which results a client keeps for the comparison: every clip among
    the longest tenth of the lengths and a seeded tenth of the others."""
    long = lengths[-1] - (lengths[-1] - lengths[0]) // 10

    def keep(req) -> bool:
        if req["frames"] >= long:
            return True
        h = np.random.default_rng([int(seed) & 0xFFFFFFFF, int(seed) >> 32,
                                   req["index"]]).random()
        return h < 0.1
    return keep


def run(run):
    cell, cfg, dev = run.cell, run.config, run.device
    tr = cell["traffic"]
    reqs = traffic.Requests(tr, run.seed)
    run.phase("imports")
    sds = weights.draw(cfg, run.seed, dev, cell["trained"])
    run.phase("weights")
    if dev == "cuda":           # the peak from here on is the program's
        torch.cuda.reset_peak_memory_stats()
    server = build_server(run, sds)
    run.phase("server")
    trace = Trace() if run.trace else None
    instrument(run, server, trace)
    pipe = server.pipeline

    # warm: the MFCC of every length the traffic sends, two full dispatches
    for n in reqs.lengths:
        pipe.audio_to_windows(reqs.waveforms[0, :traffic.samples_for_frames(
            int(n))])
    run.phase("mfcc_warm")
    lo, hi = int(reqs.lengths[0]), int(reqs.lengths[-1])
    for lengths in ((hi, lo, (lo + hi) // 2, hi), (lo, hi, lo, hi)):
        futures = [server.submit(reqs.portraits[i], reqs.waveforms[
            i, :traffic.samples_for_frames(n)], reqs.poses[i])
            for i, n in enumerate(lengths[:server.max_batch])]
        for f in futures:
            f.result()
    run.phase("dispatch_warm")
    run.facts["flops_line"] = flops.render_line(cfg)
    run.phase("flops")
    if dev == "cuda":
        torch.cuda.synchronize()

    probe_before = host_probe_ms()
    lock, stop = threading.Lock(), threading.Event()
    records = []
    keep = keep_rule(run.seed, reqs.lengths)

    def client():
        while not stop.is_set():
            with lock:
                req = reqs.next()
            t0 = time.monotonic()
            future = server.submit(req["source"], req["waveform"],
                                   req["pose"])
            try:
                out, err = future.result(), None
            except Exception as e:        # recorded as a failed request
                out, err = None, repr(e)
            t1 = time.monotonic()
            wake = t1 - getattr(future, "finished_at", t1)
            kept = out if (out is not None and keep(req)) else None
            length = None if out is None else int(out[0].shape[0])
            with lock:
                records.append({"req": req, "t0": t0, "t1": t1, "err": err,
                                "length": length, "out": kept,
                                "wake": wake})

    threads = [threading.Thread(target=client, daemon=True)
               for _ in range(int(tr["clients"]))]
    for t in threads:
        t.start()
    time.sleep(float(cell.get("settle_s", 3)))
    server.reset_stats()
    use0 = resource.getrusage(resource.RUSAGE_SELF)
    run.window_start = t_start = time.monotonic()
    time.sleep(max(0.0, t_start + run.seconds - time.monotonic()))
    t_end = time.monotonic()
    use1 = resource.getrusage(resource.RUSAGE_SELF)
    stats = server.stats()
    stop.set()
    deadline = time.monotonic() + float(cell.get("drain_s", 90))
    for t in threads:
        t.join(max(0.0, deadline - time.monotonic()))
    stuck = sum(t.is_alive() for t in threads)
    if dev == "cuda":
        torch.cuda.synchronize()
        run.memory_peak = torch.cuda.max_memory_allocated()
    server.stop()
    probe_after = host_probe_ms()

    with lock:
        window = [r for r in records if t_start <= r["t1"] <= t_end]
    done = [r for r in window if r["err"] is None]
    frames = sum(r["req"]["frames"] for r in done)
    lat = [r["t1"] - r["t0"] for r in done]
    run.window_s = t_end - t_start
    run.attempted = len(window) + stuck
    run.failed = len(window) - len(done) + stuck
    run.end_to_end["frames_per_s"] = frames / run.window_s
    run.end_to_end["latency_p95_s"] = (float(np.percentile(lat, 95))
                                       if lat else float("inf"))
    a, b = run.facts["flops_line"]
    run.facts.update(
        stats=stats, max_batch=server.max_batch,
        flops_delivered=sum(a + b * r["req"]["frames"] for r in done))
    if trace is not None:
        if trace.prof is not None:      # the window closed mid-trace
            trace.stop()
        trace.summarize()
        run.summary = trace.summary
    wakes = [r["wake"] for r in done]
    run.facts["diag"] = dict(
        window_means(run, "kp_stage", "decode", "dispatch"),
        frames=frames, wake_ms_mean=1e3 * float(np.mean(wakes)) if wakes
        else None, wake_ms_max=1e3 * max(wakes) if wakes else None,
        cpu_s=(use1.ru_utime + use1.ru_stime) - (use0.ru_utime
                                                 + use0.ru_stime),
        involuntary_switches=use1.ru_nivcsw - use0.ru_nivcsw,
        probe_ms_before=probe_before, probe_ms_after=probe_after)
    mismatched = sum(r["length"] != r["req"]["frames"] for r in done)

    sample = choose(run.seed, [r for r in done if r["out"] is not None],
                    int(cell["check"]["requests"]))
    del server, pipe, records
    gc.collect()
    if dev == "cuda":
        torch.cuda.empty_cache()
    ratio = compare(run, sds, sample)
    if run.facts.get("calibrate"):
        run.facts["control"] = {
            "worst_frame_gap_ratio": compare(run, sds, sample, control=True)}
    limits = cell["check"]["limits"]
    run.checks["worst_frame_gap_ratio"] = (ratio,
                                           limits["worst_frame_gap_ratio"])
    run.checks["length_mismatches"] = (float(mismatched),
                                       limits["length_mismatches"])


def choose(seed: int, kept: list, n: int) -> list:
    """The longest kept request and ``n - 1`` others drawn from the seed."""
    if not kept:
        return []
    kept = sorted(kept, key=lambda r: r["req"]["index"])
    longest = max(kept, key=lambda r: r["req"]["frames"])
    rest = [r for r in kept if r is not longest]
    rng = np.random.default_rng(int(seed) + 7)
    pick = rng.choice(len(rest), min(n - 1, len(rest)), replace=False)
    return [longest] + [rest[i] for i in sorted(pick)]


def reference_nets(config: dict, sds: dict) -> dict:
    nets = R.loaded(config, sds, ("generator", "kp_detector",
                                  "kp_detector_a", "audio_feature"))
    for net in nets.values():
        net.eval()
    return nets


def frame_gaps(got: tuple, want: tuple, block: int) -> np.ndarray:
    """Per frame, the mean absolute difference of the ``block`` x
    ``block`` means of its Y, U and V planes, in uint8 counts, over every
    block of the three."""
    total, count = 0.0, 0
    for g, w in zip(got, want):
        n, h, wd = g.shape
        d = (g.astype(np.float64) - w.astype(np.float64)).reshape(
            n, h // block, block, wd // block, block).mean((2, 4))
        total = total + np.abs(d).reshape(n, -1).sum(1)
        count += d[0].size
    return total / count


def compare(run, sds: dict, sample: list, control: bool = False) -> float:
    """The worst frame's gap (``frame_gaps``) between the sampled results
    (with ``control``, the reference's renders of the same requests in
    ``check.control``'s precision in their place) and the reference's
    renders of them, over the worst frame's gap of the yardstick's
    renders: the reference with its decode in ``check.yardstick``'s
    precision, the configuration's own.  So the number is the program's
    error in units of what its stated precision does to these frames, which
    varies from seed to seed with the random networks' sensitivity as the
    program's error does.  inf with nothing to compare."""
    if not sample:
        return float("inf")
    check = run.cell["check"]
    block = int(check["block"])
    ref = reference_nets(run.config, sds)
    lowered = {p: dict(ref, generator=reference.lowered(ref["generator"], p))
               for p in {check["yardstick"]} | (
                   {check["control"]} if control else set())}
    worst = scale = 0.0
    for r in sample:
        req = r["req"]
        args = (req["source"], req["waveform"], req["pose"], run.device,
                run.config["audio_weight"])
        want = reference.render(ref, *args)
        got = (reference.render(lowered[check["control"]], *args,
                                check["control"]) if control else r["out"])
        if got[0].shape != want[0].shape:
            return float("inf")
        worst = max(worst, float(frame_gaps(got, want, block).max()))
        scale = max(scale, float(frame_gaps(reference.render(
            lowered[check["yardstick"]], *args, check["yardstick"]), want,
            block).max()))
    run.facts.setdefault("worst_frame_block_abs", []).append(worst)
    run.facts.setdefault("yardstick_block_abs", []).append(scale)
    if scale > 0:
        return worst / scale
    return 0.0 if worst == 0 else float("inf")
