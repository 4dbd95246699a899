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

4. ``conv_forms``: the four call sites whose eval form the JAX package
   rewrites (``eamm_tpu_torch/ops/subpixel.py``): every ``UpBlock``, dense
   motion's mask and occlusion heads, the generator's final conv and the
   keypoint heads, each instance at the arguments the neutral 10 s
   request gives it (captured from that request), both forms timed in
   turns (folded, literal, literal, folded; three rounds: 6 samples) as
   device time of CUDA-graph replays, median, min and max ms; the calls
   each instance makes in the request, the forms' largest difference, and
   per site the request's total of each form (calls x median).

5. ``export``: the frozen artifact of the same models (bfloat16, yuv420)
   at batch 4, frame buckets of 128 and 256, emotion bucket 32, 4 stream
   segments and unbounded chunks of 128 frames (16 programs): each
   program's export seconds (``torch.export`` and ``torch.export.save``),
   the file's bytes, and the seconds ``RenderArtifact.load`` takes.

6. ``determinism``: the keypoint stage of a seeded 4 s clip (neutral, and
   emotional from 20 frames; ``_kp_stage_from_windows_impl``) and ATNet
   alone, each run twice with cuDNN's default algorithms and twice with
   its deterministic ones: the largest |difference| between the two runs
   of each output.

Each prints JSON lines, naming the render.  ``python3 chip_profile.py
conv_forms export`` runs only the phases named.  Without a CUDA device it
exits non-zero before printing any result.
"""
from __future__ import annotations

import json
import sys
import time

import torch

from chip_smoke import (EMOTION_FRAMES, FULL_CONFIG, card_line, clip_inputs,
                        emotion_clip, graphed, in_turns)
from eamm_tpu_torch.infer import EammPipeline, PipelineOptions
from eamm_tpu_torch.models import KPDetector, KPDetectorA
from eamm_tpu_torch.models import kp_detector as kpd
from eamm_tpu_torch.models.blocks import UpBlock
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


def capture_conv_sites(pipe: EammPipeline, render) -> dict:
    """The first arguments each call-site instance gets in ``render()``
    and its number of calls: name -> {'site', 'forms': {form: fn of no
    arguments}, 'calls'}."""
    sites, handles, patched = {}, [], []

    def record(name, site, forms):
        entry = sites.setdefault(name, {"site": site, "forms": forms,
                                        "calls": 0})
        entry["calls"] += 1

    def names(model):
        return {m: n for n, m in model.named_modules()}

    gen = pipe.generator
    dense = gen.dense_motion_network
    for model_name, model in (("generator", gen),
                              ("kp_detector", pipe.models["kp_detector"])):
        for m, n in names(model).items():
            if isinstance(m, UpBlock):
                handles.append(m.register_forward_pre_hook(
                    lambda m, args, n=f"{model_name}.{n}": record(
                        n, "UpBlock", {"folded": lambda x=args[0]: m.d2s(x),
                                       "literal": lambda x=args[0]:
                                       m.literal(x)})))
    heads, final_conv = dense.heads, gen.final_conv

    def spy_heads(pred):
        record("generator.dense_motion_network.heads", "dense motion heads",
               {"folded": lambda: dense.heads_s2d(pred),
                "literal": lambda: dense.heads_literal(pred)})
        return heads(pred)

    def spy_final(out):
        record("generator.final", "generator final conv",
               {"folded": lambda: gen.final_strided(out),
                "literal": lambda: gen.final(out)})
        return final_conv(out)

    dense.heads, gen.final_conv = spy_heads, spy_final
    patched += [(dense, "heads"), (gen, "final_conv")]
    for name in ("kp_detector", "kp_detector_a"):
        model = pipe.models[name]

        def on_features(fm, model=model, name=name):
            folded = kpd.fold_heads(model.kp, model.jacobian)   # per load
            record(f"{name} heads", "keypoint heads",
                   {"folded": lambda: kpd.heads_conv(
                       fm, model.kp, model.jacobian, folded),
                    "literal": lambda: kpd.heads_conv(
                        fm, model.kp, model.jacobian)})
        if isinstance(model, KPDetector):
            handles.append(model.predictor.register_forward_hook(
                lambda m, args, out, f=on_features: f(out)))
        elif isinstance(model, KPDetectorA):
            handles.append(model.register_forward_pre_hook(
                lambda m, args, f=on_features: f(args[0])))
    try:
        with torch.no_grad():
            render()
    finally:
        for h in handles:
            h.remove()
        for obj, attr in patched:
            delattr(obj, attr)
    return sites


def _tensors(out) -> tuple:
    return out if isinstance(out, tuple) else (out,)


def conv_forms(pipe: EammPipeline, clip) -> dict:
    """Phase 4: both forms of every call-site instance of the neutral
    request ``clip``, in turns -> the instances' rows and the sites'
    request totals."""
    sites = capture_conv_sites(
        pipe, lambda: pipe.render_uint8(*clip, add_emo=False))
    rows, totals = [], {}
    with torch.no_grad():
        for name, entry in sites.items():
            forms = entry["forms"]
            folded, literal = (_tensors(forms[k]()) for k in
                               ("folded", "literal"))
            diff = max(float((a.float() - b.float()).abs().max())
                       for a, b in zip(folded, literal) if a is not None)
            times = in_turns({k: graphed(fn) for k, fn in forms.items()})
            rows.append({"instance": name, "site": entry["site"],
                         "calls": entry["calls"], "max_abs_diff": diff,
                         **{f"{k}_ms": v for k, v in times.items()}})
            total = totals.setdefault(entry["site"],
                                      {"folded_ms": 0.0, "literal_ms": 0.0})
            for k in forms:
                total[f"{k}_ms"] += entry["calls"] * times[k]["median"]
    return {"instances": rows, "sites": totals}


def export_phase(pipe: EammPipeline) -> dict:
    """Phase 5: export and load the artifact; seconds and bytes."""
    import dataclasses
    import os
    import tempfile

    from eamm_tpu_torch.infer.export import (RenderArtifact,
                                             export_render_artifact)
    live = EammPipeline(FULL_CONFIG, models=pipe.models,
                        options=dataclasses.replace(
                            pipe.options, transfer_format="yuv420",
                            segment_frames=128, stream_policy_frames=256))
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "model.eammx")
        t0 = time.perf_counter()
        meta = export_render_artifact(
            live, path, batch=4, frame_buckets=(128, 256), emotional=True,
            emo_frame_buckets=(32,), stream_segments=4, unbounded_frames=128)
        wall = time.perf_counter() - t0
        art, t_load = timed(lambda: RenderArtifact.load(path))
        return {"export_wall_s": wall, "program_seconds":
                meta["export_seconds"], "bytes": os.path.getsize(path),
                "load_s": t_load, "programs": len(art._programs)}


def determinism(pipe: EammPipeline) -> dict:
    """Phase 6: two runs of the same keypoint-stage calls, with cuDNN's
    default algorithms and with its deterministic ones -> setting -> call
    -> the largest |difference| of each output."""
    src, wav, pose = clip_inputs(4.0, 5)
    T, source, wav_p, pose_p = pipe._prepare(src, wav, pose)
    windows = audio_to_mfcc_windows(wav_p)[:pose_p.shape[0]]
    nhwc = source.permute(0, 2, 3, 1)
    frames = torch.as_tensor(emotion_clip(20, 7), device=pipe.device)
    index = torch.arange(pose_p.shape[0], device=pipe.device) % 20
    calls = {
        "kp_stage_neutral": lambda: pipe._kp_stage_from_windows_impl(
            nhwc, windows, pose_p),
        "kp_stage_emotional": lambda: pipe._kp_stage_from_windows_impl(
            nhwc, windows, pose_p, frames, index),
        "atnet": lambda: (pipe.models["audio_feature"](
            source, windows[None], pose_p[None], audio_weight=1.6),)}
    out = {}
    for setting in (False, True):
        torch.backends.cudnn.deterministic = setting
        with torch.no_grad():
            out[f"deterministic_{setting}"] = {
                name: [float((a.float() - b.float()).abs().max())
                       for a, b in zip(fn(), fn())]
                for name, fn in calls.items()}
    torch.backends.cudnn.deterministic = False
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_profile: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    print(card_line(), flush=True)
    torch.backends.cudnn.allow_tf32 = False       # as chip_smoke.py runs it
    torch.backends.cuda.matmul.allow_tf32 = False
    phases = set(sys.argv[1:]) or {"stages", "host_copy", "profile",
                                   "conv_forms", "export", "determinism"}
    pipe = EammPipeline.from_random(FULL_CONFIG, 0, PipelineOptions(
        frame_chunk=32, time_bucket=32, compute_dtype=torch.bfloat16))
    video = emotion_clip(EMOTION_FRAMES, 7)
    warm = clip_inputs(1.0, 100)
    pipe.render_uint8(*warm, add_emo=False)                 # warm-ups
    pipe.render_uint8(*warm, pipe.prepare_emotion(video))
    handle, t_handle = timed(lambda: pipe.prepare_emotion(video))
    print(json.dumps({"phase": "prepare_emotion", "frames": EMOTION_FRAMES,
                      "seconds": t_handle}), flush=True)
    if "host_copy" in phases:
        print(json.dumps({"phase": "host_copy",
                          "threads": torch.get_num_threads(),
                          **host_copies()}), flush=True)
    clip = clip_inputs(10.0, 3)
    if "conv_forms" in phases:
        print(json.dumps({"phase": "conv_forms", "frames": 249,
                          **conv_forms(pipe, clip)}), flush=True)
    for render, h in (("neutral", None), ("emotional handle", handle)):
        for rep in range(3 if "stages" in phases else 0):
            print(json.dumps({"phase": "stages", "render": render, "rep": rep,
                              **stages(pipe, clip, h)}), flush=True)
        if "profile" in phases:
            print(json.dumps({"phase": "profile", "render": render,
                              **profile(pipe, clip, h)}), flush=True)
    if "determinism" in phases:
        print(json.dumps({"phase": "determinism", **determinism(pipe)}),
              flush=True)
    if "export" in phases:
        print(json.dumps({"phase": "export", **export_phase(pipe)}),
              flush=True)
    print(card_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
