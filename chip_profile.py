#!/usr/bin/env python3
"""Where the port's main-path time goes on one NVIDIA GPU.

Run from the repository root with no arguments: ``python3 chip_profile.py``.
It builds the same pipeline as ``chip_smoke.py``'s main path (FULL_CONFIG,
random weights from seed 0, bfloat16 generator, frame_chunk 32,
time_bucket 32, TF32 off), warms it up on a 1 s clip, and then, for a
10 s clip rendered neutral and emotional (``linear_3``, through a
``prepare_emotion`` handle of chip_smoke's seeded 50-frame emotion clip,
so the render runs the emotion heads per timestep but not the trunk):

1. ``stages``: host-clock seconds of the pipeline's stages, each ended by
   ``torch.cuda.synchronize()``: host preparation and upload, MFCC,
   ``clip_keypoints`` (with the emotion stage, when emotional),
   ``decode_clip`` and the copy to the host (into pinned memory on the
   copy stream, as the renders deliver); three repetitions; and, once,
   the seconds of ``prepare_emotion``.
2. ``host_copy``: a 49 MB clip's copy from the card into pinned memory,
   and from there into fresh pageable arrays by numpy and by PyTorch, in
   turns (``host_copies``).
3. ``profile``: one ``render_uint8`` call under ``torch.profiler`` (CPU and
   CUDA activity): the wall seconds, the summed device time of all
   kernels and copies, the operators whose own launches took the most
   device time (self time, so nested operators are not counted twice), and
   the kernels that took the most.

Each prints JSON lines, naming the render.  Without a CUDA device it exits non-zero before
printing any result.
"""
from __future__ import annotations

import json
import sys
import time

import torch

from chip_smoke import (EMOTION_FRAMES, FULL_CONFIG, card_line, clip_inputs,
                        emotion_clip)
from eamm_tpu_torch.infer import EammPipeline, PipelineOptions
from eamm_tpu_torch.ops.mfcc import audio_to_mfcc_windows

TOP = 25


def timed(fn):
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def stages(pipe: EammPipeline, clip, handle=None) -> dict:
    with torch.no_grad():
        (T, source, wav, pose), t_prep = timed(lambda: pipe._prepare(*clip))
        Tp = pose.shape[0]
        emotion = (None if handle is None
                   else pipe._emotion_input(handle, Tp))
        windows, t_mfcc = timed(lambda: audio_to_mfcc_windows(wav)[:Tp])
        (kp_norm, kp_s), t_kp = timed(
            lambda: pipe.clip_keypoints(source, windows, pose, emotion))
        frames, t_dec = timed(lambda: pipe.decode_clip(source, kp_norm, kp_s))
        _, t_host = timed(lambda: pipe.link.fetch((frames,), T))
    return {"frames": T, "prepare_s": t_prep, "mfcc_s": t_mfcc,
            "keypoints_s": t_kp, "decode_s": t_dec, "to_host_s": t_host}


def profile(pipe: EammPipeline, clip, handle=None) -> dict:
    from torch.profiler import ProfilerActivity, profile as torch_profile
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch_profile(activities=acts) as prof:
        t0 = time.perf_counter()
        pipe.render_uint8(*clip, handle, add_emo=handle is not None)
        wall = time.perf_counter() - t0

    def self_us(evt):
        return getattr(evt, "self_device_time_total",
                       getattr(evt, "self_cuda_time_total", 0.0))

    def rows(evts):
        return [{"name": e.key[:120], "count": e.count,
                 "self_device_ms": self_us(e) / 1e3}
                for e in sorted(evts, key=self_us, reverse=True)[:TOP]]

    from torch.autograd import DeviceType
    events = [e for e in prof.key_averages() if self_us(e) > 0]
    kernels = [e for e in events if e.device_type == DeviceType.CUDA]
    ops = [e for e in events if e.device_type != DeviceType.CUDA]
    return {"wall_s": wall,
            "device_s": sum(self_us(e) for e in kernels) / 1e6,
            "ops": rows(ops), "kernels": rows(kernels)}


def host_copies(rounds: int = 4) -> dict:
    """Milliseconds a 10 s clip's frames (249 x 256 x 256 x 3 uint8, 49 MB)
    take from the card into a reused pinned staging buffer, and from there
    into a fresh pageable array, each array kept as a caller keeps its
    results: numpy's one-thread copy and PyTorch's threaded copy (the one
    ``HostFetch.result`` makes), in turns."""
    shape = (249, 256, 256, 3)
    src = torch.randint(0, 256, shape, dtype=torch.uint8, device="cuda")
    pinned = torch.empty(shape, dtype=torch.uint8, pin_memory=True)
    held = []
    out = {"card_to_pinned_ms": [], "numpy_copy_ms": [], "torch_copy_ms": []}
    for _ in range(rounds):
        for key, fn in (
                ("card_to_pinned_ms",
                 lambda: pinned.copy_(src, non_blocking=True)),
                ("numpy_copy_ms", lambda: pinned.numpy().copy()),
                ("torch_copy_ms", lambda: torch.empty(
                    shape, dtype=torch.uint8).copy_(pinned))):
            result, seconds = timed(fn)
            if key != "card_to_pinned_ms":
                held.append(result)
            out[key].append(seconds * 1e3)
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_profile: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    print(card_line(), flush=True)
    torch.backends.cudnn.allow_tf32 = False       # as chip_smoke.py runs it
    torch.backends.cuda.matmul.allow_tf32 = False
    pipe = EammPipeline.from_random(FULL_CONFIG, 0, PipelineOptions(
        frame_chunk=32, time_bucket=32, compute_dtype=torch.bfloat16))
    video = emotion_clip(EMOTION_FRAMES, 7)
    warm = clip_inputs(1.0, 100)
    pipe.render_uint8(*warm, add_emo=False)                 # warm-ups
    pipe.render_uint8(*warm, pipe.prepare_emotion(video))
    handle, t_handle = timed(lambda: pipe.prepare_emotion(video))
    print(json.dumps({"phase": "prepare_emotion", "frames": EMOTION_FRAMES,
                      "seconds": t_handle}), flush=True)
    print(json.dumps({"phase": "host_copy", "threads": torch.get_num_threads(),
                      **host_copies()}), flush=True)
    clip = clip_inputs(10.0, 3)
    for render, h in (("neutral", None), ("emotional handle", handle)):
        for rep in range(3):
            print(json.dumps({"phase": "stages", "render": render, "rep": rep,
                              **stages(pipe, clip, h)}), flush=True)
        print(json.dumps({"phase": "profile", "render": render,
                          **profile(pipe, clip, h)}), flush=True)
    print(card_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
