#!/usr/bin/env python3
"""Build the port's CUDA kernels and drive its main path on one NVIDIA GPU.

Run from the repository root with no arguments: ``python3 chip_smoke.py``.
It needs one CUDA device and ``nvcc``; without a device it exits non-zero
before printing any result.  It imports ``eamm_tpu_torch``, torch, numpy
and the standard library, nothing of JAX.

Phases, each printing one JSON line; any failure raises (exit code 1):

1. device: the card (``nvidia-smi`` name and power limit), torch and CUDA
   versions; TF32 is switched off for cuDNN and matmul, so float32 phases
   run in full float32.
2. build: every ``eamm_tpu_torch/csrc/*.cu``, one nvcc each, in parallel;
   seconds and ptxas's registers, shared memory and spills per kernel.
3. kernel parity: each kernel against its plain PyTorch version on the
   card at the main path's shapes, plus a second source (Bi=2) and ragged
   outputs ([3,5,7], [2,13,17] over two sources) that are not multiples of
   the kernels' tiles; grids from U(-1.2, 1.2) put corners outside the
   image, and one grid per warp lies wholly outside it (all zeros).  Warp
   grids come in the image dtype, as on the main path, plus one case each
   in the other dtype and one with align_corners=True.  The shared warp
   at [64,64,256] by [32,64,64,2] in both dtypes and both align_corners,
   and at C = 3 and 35; the fused keypoint expectation at [256,10,58,58]
   with and without the heatmap, in bfloat16 with and without it, with
   pred and jmap in different dtypes (both ways), contiguous, at
   temperature 1, with peaked rows (one logit 30 above the rest) and flat
   ones, 4 bytes off 16, at [1,10,58,58] (fewer rows than SMs), at a ragged
   [3,2,13,17], at its largest row [1,2,200,240] in both dtypes and at
   its widest [1,1,2,24576].
   Each output within its dtype's tolerance: float32 within 1e-5 (abs
   and rel), bfloat16 within 1e-2 (abs and rel: one output rounding on
   unit-scale data); the warps' at their inputs' dtype, the keypoint
   expectations' value and jacobian (float32 from any input dtype) at
   float32's.  After phase 5, the wide and
   narrow warps again at the main path's own arguments, captured from the
   first decode chunk of a neutral 10 s request and of the batched render
   of 4 identities (4 sources, Bi = 4).
4. CPU vs card: the same seeded weights and clip rendered by the port on
   the CPU (plain versions) and on the card (kernels) in float32, neutral
   at TINY_CONFIG widths and emotional (5 emotion frames) at
   EMOTION_TINY_CONFIG; per-frame mean |difference| max < 1e-2, mean
   < 3e-3.
5. main paths, each at FULL_CONFIG (the emotion model at the reference's
   hard-coded widths), bfloat16, frame_chunk 32, time_bucket 32, after one
   warm-up request per route; per request the frames, wall seconds, fps and each
   kernel's launches (counts zeroed just before the request, read just
   after; each kernel the path runs must have launched):
   - neutral (``add_emo=False``): 1 s, 4 s and 10 s; the 4 s clip again
     in float32, bfloat16 within mean 0.5 and p99 2 uint8 counts of it;
   - emotional (``linear_3``, a seeded 50-frame emotion clip): 1 s (Tp 32
     <= 50: the whole model per frame in float32), 4 s and 10 s (the trunk
     per unique frame in bfloat16), passing the frames; the same three
     through one ``prepare_emotion`` handle, within 1 count of the frames
     where both take the trunk route (4 s, 10 s) and within the bfloat16
     bound where they do not (1 s); one 4 s request with the map head,
     whose keypoints launch the keypoint expectation once more; the 4 s
     clip in float32, bfloat16 within mean 0.75 and p99 3 counts of it;
   - yuv420 delivery: a neutral 10 s ``render_yuv420`` and an emotional
     4 s cold render whose frames are uploaded as packed planes, each
     turned back into RGB within mean 5e-3 and max 0.2 (in [0, 1]) of the
     rgb render;
   - overlapped segments: 10 s neutral rgb, neutral yuv420 and emotional
     (raw frames, the split keypoint stage) with ``overlap_segments`` 4,
     each bitwise equal to one segment, with both wall times;
   - ``render_stream`` over 4 segments of a 10 s clip: seconds to the
     first and the last payload, bitwise equal to ``render_uint8``;
   - three 10 s renders held at once: each result pageable, the caching
     host allocator's page-locked bytes after each (not growing);
   - unbounded chunks (``segment_frames`` 64): 4 s neutral and emotional
     (handle, 50 frames < T) streams in float32 within 1 count of the
     whole clip; 10 s and 60 s neutral streams in bfloat16, the 60 s peak
     memory within 5% of the 10 s one, beside the whole 10 s clip's, and
     the 10 s stream's difference from that clip; with
     ``stream_policy_frames`` 250, the route a 4 s and a 20 s
     ``render_uint8`` took (whole clip, then chunks);
   - batched: ``render_batch_uint8`` of 4 identities of 4, 3.5, 3 and 2 s,
     in float32 each within 1 count of its own ``render_uint8``; in
     bfloat16 ``render_batch_yuv420`` in 2 segments bitwise equal to one;
   - entry points: the shared warp and the fused keypoint expectation,
     which no model calls, once each at the shapes of phase 6.
   Peak device memory of each path.
6. kernel times at the main-path shapes: the kernel, its plain version,
   one PyTorch library call computing the same function where there is
   one, and the bound (the larger of bytes at 3.35 TB/s and operations at
   67 TFLOP/s f32).  A kernel's and a library call's ``ms`` are device
   time: CUDA events around replays of 20 calls captured in a CUDA graph,
   so the wrappers' Python is left out (eager calls back to back time the
   host below ~0.02 ms a call).  The three warps are timed at two inputs,
   the random grid and the main path's captured arguments, each in 6
   samples of ~20 ms taken in turns (kernel, library, store-only,
   store-only, library, kernel; three rounds), as median, min and max,
   both replayed and eager (``call_ms``); the store-only kernel writes the
   output's bytes and nothing else, the card's write ceiling.  The fused
   keypoint expectation is timed three ways (float32 with and without the
   heatmap, bfloat16 with it), each with its own bound, in the same turns
   as K3 on the same float32 inputs (``timing`` in its row, with the
   launch ``plan`` the wrapper makes for the first).
   The plain versions are timed eager.

Then the card's name and power limit, the ``{"kernels": [...]}`` line
(with the path whose launches each row counts, and the launches on every
request by path), and last
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

from eamm_tpu_torch import config as cfg
from eamm_tpu_torch import kernels
from eamm_tpu_torch.infer import EammPipeline, PipelineOptions
from eamm_tpu_torch.infer.pipeline import reset_parameters
from eamm_tpu_torch.ops.colorspace import yuv420_to_rgb
from eamm_tpu_torch.ops import kp_expectation as kpx
from eamm_tpu_torch.ops import warp_cuda

# the published widths (bench.py FULL_CONFIG)
FULL_CONFIG = {
    "model_params": {
        "common_params": {"num_kp": 10, "num_channels": 3,
                          "estimate_jacobian": True},
        "audio_params": {"num_kp": 10, "num_channels": 3, "num_channels_a": 3,
                         "estimate_jacobian": True},
        "kp_detector_params": {"temperature": 0.1, "block_expansion": 32,
                               "max_features": 1024, "scale_factor": 0.25,
                               "num_blocks": 5},
        "generator_params": {"block_expansion": 64, "max_features": 512,
                             "num_down_blocks": 2, "num_bottleneck_blocks": 6,
                             "estimate_occlusion_map": True,
                             "dense_motion_params": {
                                 "block_expansion": 64, "max_features": 1024,
                                 "num_blocks": 5, "scale_factor": 0.25}},
        "discriminator_params": {"scales": [1], "block_expansion": 32,
                                 "max_features": 512, "num_blocks": 4,
                                 "sn": True},
    },
    "train_params": {"jaco_net": "cnn"},
}

# narrow widths of the test suite (tests/conftest.py TINY_CONFIG)
TINY_CONFIG = {
    "model_params": {
        "common_params": {"num_kp": 10, "num_channels": 3,
                          "estimate_jacobian": True},
        "audio_params": {"num_kp": 10, "num_channels": 3, "num_channels_a": 3,
                         "estimate_jacobian": True},
        "kp_detector_params": {"temperature": 0.1, "block_expansion": 8,
                               "max_features": 32, "scale_factor": 0.25,
                               "num_blocks": 3},
        "generator_params": {"block_expansion": 8, "max_features": 32,
                             "num_down_blocks": 2, "num_bottleneck_blocks": 1,
                             "estimate_occlusion_map": True,
                             "dense_motion_params": {
                                 "block_expansion": 8, "max_features": 32,
                                 "num_blocks": 3, "scale_factor": 0.25}},
        "discriminator_params": {"scales": [1], "block_expansion": 8,
                                 "max_features": 32, "num_blocks": 3,
                                 "sn": True},
    },
    "train_params": {"jaco_net": "cnn"},
}

# TINY_CONFIG with a narrow emotion hourglass (the emotion model ignores
# the other widths: the reference hard-codes 32 / 1024 / 5)
EMOTION_TINY_CONFIG = {
    **TINY_CONFIG,
    "model_params": {**TINY_CONFIG["model_params"],
                     "emotion_params": {"block_expansion": 8,
                                        "max_features": 32, "num_blocks": 3}},
}

HBM_BYTES_PER_S = 3.35e12       # H100 SXM device memory
F32_OPS_PER_S = 67e12           # H100 SXM float32 outside the tensor cores
TOL = {torch.float32: 1e-5, torch.bfloat16: 1e-2}
REQUEST_SECONDS = (1.0, 4.0, 10.0)
EMOTION_FRAMES = 50
YUV_BOUND = (5e-3, 0.2)         # mean and max |difference| in [0, 1]
STREAM_FRAMES = 64              # segment_frames of the unbounded route
POLICY_FRAMES = 250             # stream_policy_frames of the policy check
BATCH_SECONDS = (4.0, 3.5, 3.0, 2.0)
REQUESTS: list = []             # every request line, in order

# name -> (wrapper, plain version, source, TPU kernel it replaces)
KERNELS = {
    "warp_wide": (warp_cuda.grid_sample_wide, warp_cuda.grid_sample_plain,
                  "eamm_tpu_torch/csrc/warp.cu",
                  "eamm_tpu/ops/warp_pallas.py:244"),
    "warp_narrow": (warp_cuda.grid_sample_narrow, warp_cuda.grid_sample_plain,
                    "eamm_tpu_torch/csrc/warp.cu",
                    "eamm_tpu/ops/warp_pallas.py:143"),
    "kp_expectation": (kpx.kp_expectation, kpx.kp_expectation_plain,
                       "eamm_tpu_torch/csrc/kp_expectation.cu",
                       "eamm_tpu/ops/kp_expectation.py:110"),
    "warp_shared": (warp_cuda.grid_sample_shared,
                    warp_cuda.grid_sample_shared_plain,
                    "eamm_tpu_torch/csrc/warp.cu",
                    "eamm_tpu/ops/warp_pallas.py:64"),
    "kp_expectation_fused": (kpx.kp_expectation_fused,
                             kpx.kp_expectation_fused_plain,
                             "eamm_tpu_torch/csrc/kp_expectation.cu",
                             "eamm_tpu/ops/kp_pallas.py:79"),
}
RENDER_KERNELS = ("warp_wide", "warp_narrow", "kp_expectation")


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def launch_counts() -> dict:
    return {name: k[0].launches for name, k in KERNELS.items()}


def reset_launch_counts() -> None:
    for wrapper, *_ in KERNELS.values():
        wrapper.launches = 0


def clip_inputs(seconds: float, seed: int):
    rng = np.random.RandomState(seed)
    src = rng.rand(256, 256, 3).astype(np.float32)
    wav = (0.1 * rng.randn(int(16000 * seconds))).astype(np.float32)
    pose = rng.randn(1, 7).astype(np.float32)
    return src, wav, pose


def emotion_clip(frames: int, seed: int) -> np.ndarray:
    """Seeded float32 emotion frames [frames, 256, 256, 3] in [0, 1]."""
    return np.random.RandomState(seed).rand(frames, 256, 256, 3).astype(
        np.float32)


def uint8_diff(a: np.ndarray, b: np.ndarray) -> dict:
    d = np.abs(a.astype(np.float32) - b.astype(np.float32))
    return {"mean": float(d.mean()), "p99": float(np.percentile(d, 99)),
            "max": float(d.max())}


# ---------------------------------------------------------------- phase 3

def warp_case(Bi: int, B: int, hw: tuple[int, int], C: int,
              dtype: torch.dtype, gen: torch.Generator,
              grid_dtype: torch.dtype | None = None, outside: bool = False):
    """A random [Bi,64,64,C] image and a [B,*hw,2] grid in U(-1.2, 1.2),
    the grid in the image dtype unless ``grid_dtype`` is given; with
    ``outside``, |x| and |y| in [1.5, 3], so every corner lies outside."""
    image = torch.randn((Bi, 64, 64, C), generator=gen, device="cuda"
                        ).to(dtype)
    grid = torch.rand((B, *hw, 2), generator=gen, device="cuda") * 2.4 - 1.2
    if outside:
        grid = torch.sign(grid) * (1.5 + grid.abs() * 1.25)
    return (image, grid.to(grid_dtype or dtype))


def kp_case(B: int, gen: torch.Generator, h: int = 58, w: int = 58,
            K: int = 10, dtype: torch.dtype = torch.float32,
            jdtype: torch.dtype | None = None, sliced: bool = True,
            temperature: float = 0.1, logits: str = "random",
            offset: int = 0):
    """(pred, jmap, temperature) as the heads pass them: slices of one conv
    output (of two where ``jdtype``, jmap's dtype, differs from pred's),
    starting ``offset`` values into its storage, or contiguous tensors
    unless ``sliced``.  ``logits`` "peaked" puts one logit per row 30 above
    the rest (all 0), "flat" makes them all equal."""
    jdtype = jdtype or dtype
    if sliced:
        y = torch.randn(B * 5 * K * h * w + offset, generator=gen,
                        device="cuda")[offset:].view(B, 5 * K, h, w)
        yj = y if jdtype == dtype else torch.randn(
            (B, 5 * K, h, w), generator=gen, device="cuda")
        pred = y.to(dtype)[:, :K]
        jmap = yj.to(jdtype)[:, K:].view(B, K, 4, h, w)
    else:
        pred = torch.randn((B, K, h, w), generator=gen, device="cuda").to(dtype)
        jmap = torch.randn((B, K, 4, h, w), generator=gen, device="cuda"
                           ).to(jdtype)
    if logits != "random":
        pred.zero_()
    if logits == "peaked":
        at = torch.randint(h * w, (B, K, 1), generator=gen, device="cuda")
        pred.flatten(2).scatter_(2, at, 30.0)
    return (pred, jmap, temperature)


def parity_cases() -> list:
    """(kernel, dtype, args, options) of every phase-3 case but the
    captured ones."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    cases = []
    for dtype in (torch.float32, torch.bfloat16):
        other = torch.bfloat16 if dtype == torch.float32 else torch.float32
        for name, C, B in (("warp_wide", 256, 32), ("warp_narrow", 3, 352)):
            for Bi, n, hw in ((1, B, (64, 64)), (2, B, (64, 64)),
                              (1, 3, (5, 7)), (2, 2, (13, 17))):
                cases.append((name, dtype, warp_case(Bi, n, hw, C, dtype, gen),
                              {}))
            cases.append((name, dtype, warp_case(1, 4, (64, 64), C, dtype, gen,
                                                 grid_dtype=other), {}))
            cases.append((name, dtype, warp_case(1, B, (64, 64), C, dtype, gen),
                          {"align_corners": True}))
            cases.append((name, dtype, warp_case(1, 4, (64, 64), C, dtype, gen,
                                                 outside=True), {}))
        for align in (False, True):
            image, grid = warp_case(1, 32, (64, 64), 256, dtype, gen)
            cases.append(("warp_shared", dtype, (image[0], grid),
                          {"align_corners": align}))
        for C in (3, 35):
            image, grid = warp_case(1, 3, (5, 7), C, dtype, gen)
            cases.append(("warp_shared", dtype, (image[0], grid), {}))
    for B, hw in ((256, (58, 58)), (1, (58, 58)), (3, (13, 17))):
        cases.append(("kp_expectation", torch.float32, kp_case(B, gen, *hw), {}))
    for heat in (True, False):
        cases.append(("kp_expectation_fused", torch.float32, kp_case(256, gen),
                      {"want_heatmap": heat}))
    cases.append(("kp_expectation_fused", torch.bfloat16,
                  kp_case(256, gen, dtype=torch.bfloat16),
                  {"want_heatmap": True}))
    cases.append(("kp_expectation_fused", torch.float32,
                  kp_case(3, gen, 13, 17, K=2), {"want_heatmap": True}))
    # the fused kernel's other paths: mixed dtypes, contiguous inputs, rows
    # 4 bytes off 16 (loose pixels at both ends), fewer rows than SMs, no
    # heatmap in bfloat16, temperature 1, peaked and flat rows, the largest
    # row it takes, and the widest (its coordinate tables do not fit)
    heat = {"want_heatmap": True}
    for pd, jd in ((torch.bfloat16, torch.float32),
                   (torch.float32, torch.bfloat16)):
        cases.append(("kp_expectation_fused", pd,
                      kp_case(256, gen, dtype=pd, jdtype=jd), heat))
    for pd, args, kw in (
            (torch.float32, kp_case(256, gen, sliced=False), heat),
            (torch.float32, kp_case(256, gen, offset=1), heat),
            (torch.float32, kp_case(1, gen), heat),
            (torch.bfloat16, kp_case(256, gen, dtype=torch.bfloat16),
             {"want_heatmap": False}),
            (torch.float32, kp_case(256, gen, temperature=1.0), heat),
            (torch.float32, kp_case(256, gen, logits="peaked"), heat),
            (torch.float32, kp_case(256, gen, logits="flat"), heat),
            (torch.float32, kp_case(1, gen, 200, 240, K=2), heat),
            (torch.bfloat16, kp_case(1, gen, 200, 240, K=2,
                                     dtype=torch.bfloat16), heat),
            (torch.float32, kp_case(1, gen, 2, 24576, K=1), heat)):
        cases.append(("kp_expectation_fused", pd, args, kw))
    return cases


def captured_cases(captured: dict) -> list:
    """The wide and narrow warps at the main path's own arguments."""
    return [(name, captured[name][0].dtype, captured[name], {})
            for name in ("warp_wide", "warp_narrow")]


def parity(cases: list, worst: dict | None = None) -> dict:
    """Each case's kernel against its plain version; returns the largest
    |error| per kernel, taken together with ``worst``.  A warp's output is
    held to its case's dtype's TOL; the keypoint expectations' outputs each
    to their own dtype's (value and jacobian are float32 whatever the
    inputs; the heatmap is in pred's dtype)."""
    worst = dict(worst or {name: 0.0 for name in KERNELS})
    for name, dtype, args, kw in cases:
        wrapper, plain = KERNELS[name][:2]
        got, want = wrapper(*args, **kw), plain(*args, **kw)
        torch.cuda.synchronize()
        if not isinstance(got, tuple):
            got, want = (got,), (want,)
        tols = []
        err = 0.0
        for g, w in zip(got, want):
            if g is None and w is None:
                continue
            tol = TOL[g.dtype if name.startswith("kp") else dtype]
            tols.append(tol)
            torch.testing.assert_close(g, w, rtol=tol, atol=tol)
            err = max(err, (g.float() - w.float()).abs().max().item())
        if name.startswith("warp") and args[1].float().abs().min() >= 1.5 \
                and got[0].abs().max() != 0:
            raise AssertionError(f"{name}: nonzero output for a grid "
                                 "wholly outside the image")
        worst[name] = max(worst[name], err)
        tensors = [a for a in args if torch.is_tensor(a)]
        emit("parity", kernel=name, dtypes=[str(a.dtype) for a in tensors],
             shapes=[list(a.shape) for a in tensors],
             strides=[list(a.stride()) for a in tensors],
             temperature=args[2] if name.startswith("kp") else None,
             options=kw, max_abs_err=err, tol=tols)
    return worst


# ---------------------------------------------------------------- phase 4

def cpu_vs_device(device: str = "cuda", seed: int = 0,
                  emotion: bool = False) -> dict:
    """The same seeded pipeline and 1 s clip rendered on the CPU and on
    ``device``, neutral at TINY_CONFIG or, with ``emotion``, emotional at
    EMOTION_TINY_CONFIG with 5 emotion frames; raises unless per-frame
    mean |difference| has max < 1e-2 and mean < 3e-3."""
    config = EMOTION_TINY_CONFIG if emotion else TINY_CONFIG
    opts = dict(frame_chunk=8, time_bucket=8)
    cpu = EammPipeline.from_random(config, seed,
                                   PipelineOptions(device="cpu", **opts))
    dev = EammPipeline.from_random(config, seed,
                                   PipelineOptions(device=device, **opts))
    src, wav, pose = clip_inputs(1.0, seed)
    video = emotion_clip(5, seed) if emotion else None
    a = cpu.render(src, wav, pose, video, add_emo=emotion)
    b = dev.render(src, wav, pose, video, add_emo=emotion)
    if a.shape != b.shape:
        raise AssertionError(f"shapes differ: {a.shape} vs {b.shape}")
    l1 = np.abs(a - b).mean(axis=(1, 2, 3))
    result = {"emotion": emotion, "frames": int(a.shape[0]),
              "l1_max": float(l1.max()), "l1_mean": float(l1.mean())}
    if not (l1.max() < 1e-2 and l1.mean() < 3e-3):
        raise AssertionError(f"CPU vs {device} render differs: {result}")
    return result


# ---------------------------------------------------------------- phase 5

def frames_out(out) -> int:
    """Frames in a render's output: uint8 RGB [..., 256, 256, 3], or
    yuv420 planes (Y [..., 256, 256], U and V [..., 128, 128]); raises
    unless it is well formed and not constant."""
    if isinstance(out, tuple):
        y, u, v = out
        ok = (y.dtype == u.dtype == v.dtype == np.uint8
              and y.shape[-2:] == (256, 256)
              and u.shape == v.shape == y.shape[:-2] + (128, 128))
        lead = y.shape[:-2]
    else:
        y = out
        ok = out.dtype == np.uint8 and out.shape[-3:] == (256, 256, 3)
        lead = out.shape[:-3]
    if not ok or y.std() == 0:
        raise AssertionError(f"bad output {[np.shape(a) for a in out]}"
                             if isinstance(out, tuple) else
                             f"bad frames {out.shape} {out.dtype}")
    return int(np.prod(lead))


def drive(path: str, must: tuple, fn, seconds: float | None = None,
          info: dict | None = None):
    """Run ``fn`` with every launch count zeroed just before and read just
    after; raise unless each kernel in ``must`` launched.  With
    ``seconds`` (the audio rendered), check the frames and report them and
    the fps; ``info`` (which ``fn`` may fill) joins the line.  Returns
    (its result, the counts)."""
    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    out = fn()                                 # a render ends on the host
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = launch_counts()
    fields = {"path": path, "wall_seconds": wall, "launches": launches}
    if seconds is not None:
        frames = frames_out(out)
        if frames < 20 * seconds:
            raise AssertionError(f"{path}: {frames} frames for {seconds} s")
        fields.update(clip_seconds=seconds, frames=frames, fps=frames / wall)
    fields.update(info or {})
    REQUESTS.append(fields)
    emit("request", **fields)
    missing = [name for name in must if launches[name] <= 0]
    if missing:
        raise AssertionError(f"{path}: not launched: {missing} ({launches})")
    return out, launches


def main_path(opts: PipelineOptions) -> tuple[EammPipeline, dict]:
    """The neutral render; returns the pipeline and the 10 s request's
    launch counts."""
    t0 = time.perf_counter()
    pipe = EammPipeline.from_random(FULL_CONFIG, 0, opts)
    torch.cuda.synchronize()
    emit("main_path_setup", seconds=time.perf_counter() - t0)
    pipe.render_uint8(*clip_inputs(1.0, 100), add_emo=False)   # warm-up
    torch.cuda.reset_peak_memory_stats()
    launches = {}
    for i, seconds in enumerate(REQUEST_SECONDS):
        clip = clip_inputs(seconds, i + 1)
        _, launches = drive("neutral", RENDER_KERNELS, lambda: pipe.render_uint8(
            *clip, add_emo=False), seconds)
    peak = torch.cuda.max_memory_allocated()
    f32 = EammPipeline(FULL_CONFIG, models=pipe.models, options=dataclasses
                       .replace(opts, compute_dtype=torch.float32))
    clip = clip_inputs(4.0, 2)
    quality = uint8_diff(pipe.render_uint8(*clip, add_emo=False),
                         f32.render_uint8(*clip, add_emo=False))
    emit("bf16_vs_f32", path="neutral", clip_seconds=4.0, uint8_diff=quality)
    if not (quality["mean"] < 0.5 and quality["p99"] <= 2.0):
        raise AssertionError(f"bf16 render strays from f32: {quality}")
    emit("memory", path="neutral", max_memory_allocated=peak)
    return pipe, launches


def emotional_path(pipe: EammPipeline) -> dict:
    """The emotional render with the neutral pipeline's four models;
    returns the launch counts of the 10 s request with frames, of the
    same with the handle and of the map head's 4 s request."""
    video = emotion_clip(EMOTION_FRAMES, 7)
    for seconds in (1.0, 4.0):          # warm-up of both routes, not counted
        pipe.render_uint8(*clip_inputs(seconds, 100), video)
    pipe.prepare_emotion(video)
    torch.cuda.reset_peak_memory_stats()
    by_frames, counts = {}, {}
    for i, seconds in enumerate(REQUEST_SECONDS):
        clip = clip_inputs(seconds, i + 1)
        by_frames[seconds], counts["frames"] = drive(
            "emotional linear_3 frames", RENDER_KERNELS,
            lambda: pipe.render_uint8(*clip, video), seconds)
    handle, _ = drive("prepare_emotion", (),
                      lambda: pipe.prepare_emotion(video))
    for i, seconds in enumerate(REQUEST_SECONDS):
        clip = clip_inputs(seconds, i + 1)
        out, counts["handle"] = drive(
            "emotional linear_3 handle", RENDER_KERNELS,
            lambda: pipe.render_uint8(*clip, handle), seconds)
        diff = uint8_diff(out, by_frames[seconds])
        # fewer emotion frames than timesteps: both run the trunk per
        # unique frame in bfloat16; else the frames run the whole model
        # per frame in float32
        same_route = EMOTION_FRAMES < out.shape[0]
        emit("handle_vs_frames", clip_seconds=seconds, same_route=same_route,
             uint8_diff=diff)
        if same_route and diff["max"] > 1.0:
            raise AssertionError(f"handle strays from frames: {diff}")
        if not same_route and not (diff["mean"] < 0.75 and diff["p99"] <= 3.0):
            raise AssertionError(f"handle strays from frames: {diff}")
    peak = torch.cuda.max_memory_allocated()

    emo_map = cfg.build_emotion_detector(FULL_CONFIG, "map")
    reset_parameters(emo_map, torch.Generator().manual_seed(0))
    map_pipe = EammPipeline(
        FULL_CONFIG, models={**pipe.models, "emo_detector": emo_map},
        options=dataclasses.replace(pipe.options, emo_type="map"))
    clip = clip_inputs(4.0, 2)
    map_pipe.render_uint8(*clip_inputs(1.0, 100), video)        # warm-up
    _, counts["map"] = drive("emotional map frames", RENDER_KERNELS,
                             lambda: map_pipe.render_uint8(*clip, video), 4.0)
    if counts["map"]["kp_expectation"] <= 2:
        raise AssertionError(f"the map head did not launch the keypoint "
                             f"expectation: {counts['map']}")

    f32 = EammPipeline(FULL_CONFIG, models=pipe.models, options=dataclasses
                       .replace(pipe.options, compute_dtype=torch.float32))
    quality = uint8_diff(pipe.render_uint8(*clip, video),
                         f32.render_uint8(*clip, video))
    emit("bf16_vs_f32", path="emotional linear_3 frames", clip_seconds=4.0,
         uint8_diff=quality)
    if not (quality["mean"] < 0.75 and quality["p99"] <= 3.0):
        raise AssertionError(f"bf16 emotional render strays from f32: "
                             f"{quality}")
    emit("memory", path="emotional", max_memory_allocated=peak)
    return counts


# ------------------------------------------------- phase 5: delivery

def with_options(pipe: EammPipeline, **changes) -> EammPipeline:
    """``pipe``'s models under its options with ``changes``."""
    return EammPipeline(FULL_CONFIG, models=pipe.models,
                        options=dataclasses.replace(pipe.options, **changes))


def codec_diff(a: np.ndarray, b: np.ndarray) -> dict:
    """|a - b| in [0, 1] of two uint8 RGB renders, one of them through
    yuv420; raises outside the JAX package's bound (mean < 5e-3, max <
    0.2, tests/test_infer_pipeline.py:129-130)."""
    d = np.abs(a.astype(np.float32) - b.astype(np.float32)) / 255.0
    out = {"mean": float(d.mean()), "max": float(d.max())}
    if not (out["mean"] < YUV_BOUND[0] and out["max"] < YUV_BOUND[1]):
        raise AssertionError(f"yuv420 strays from rgb: {out}")
    return out


def same_bits(a, b, what: str) -> None:
    """Raise unless two outputs (arrays or tuples of planes) are equal bit
    for bit."""
    a, b = (a if isinstance(a, tuple) else (a,)), \
        (b if isinstance(b, tuple) else (b,))
    if len(a) != len(b) or any(x.shape != y.shape or not np.array_equal(x, y)
                               for x, y in zip(a, b)):
        raise AssertionError(f"{what}: not bitwise equal")


def joined(stream, info: dict):
    """A ``render_stream`` generator run to its end: the seconds to its
    first and to its last payload go into ``info``; returns the payloads
    put together."""
    t0 = time.perf_counter()
    parts = []
    for _, payload in stream:
        if not parts:
            info["first_payload_seconds"] = time.perf_counter() - t0
        parts.append(payload)
    info["last_payload_seconds"] = time.perf_counter() - t0
    info["payloads"] = len(parts)
    if isinstance(parts[0], tuple):
        return tuple(np.concatenate(x) for x in zip(*parts))
    return np.concatenate(parts)


def yuv420_path(pipe: EammPipeline, video: np.ndarray) -> None:
    """A neutral 10 s ``render_yuv420`` and an emotional 4 s cold render
    whose emotion frames are uploaded as packed planes, each against the
    rgb render."""
    yuv = with_options(pipe, transfer_format="yuv420")
    yuv.render_yuv420(*clip_inputs(1.0, 100), add_emo=False)    # warm-ups
    yuv.render_yuv420(*clip_inputs(4.0, 100), video)
    for label, seconds, args in (("neutral", 10.0, (None, False)),
                                 ("emotional frames, packed upload", 4.0,
                                  (video, True))):
        clip = clip_inputs(seconds, 3)
        planes, _ = drive(f"{label} yuv420", RENDER_KERNELS,
                          lambda: yuv.render_yuv420(*clip, *args), seconds)
        emit("yuv420_vs_rgb", path=label, clip_seconds=seconds,
             shapes=[list(p.shape) for p in planes],
             diff=codec_diff(yuv420_to_rgb(*planes),
                             pipe.render_uint8(*clip, *args)))


def overlap_path(pipe: EammPipeline, video: np.ndarray) -> None:
    """10 s renders in 4 overlapped segments against one segment, on the
    card: neutral rgb, neutral yuv420 and emotional with raw frames (the
    split keypoint stage); bitwise equal."""
    yuv = with_options(pipe, transfer_format="yuv420")
    clip = clip_inputs(10.0, 3)
    cases = (("neutral rgb", pipe, "render_uint8", (None, False)),
             ("neutral yuv420", yuv, "render_yuv420", (None, False)),
             ("emotional rgb frames", pipe, "render_uint8", (video, True)))
    for label, one, method, args in cases:
        four = with_options(one, overlap_segments=4)
        getattr(four, method)(*clip_inputs(1.0, 100), *args)      # warm-up
        walls, outs = [], []
        for S, p in ((1, one), (4, four)):
            out, _ = drive(f"{label} S={S}", RENDER_KERNELS,
                           lambda: getattr(p, method)(*clip, *args), 10.0)
            walls.append(REQUESTS[-1]["wall_seconds"])
            outs.append(out)
        same_bits(*outs, f"{label}: S=4 against S=1")
        emit("overlap_vs_single", path=label, clip_seconds=10.0,
             s1_wall_seconds=walls[0], s4_wall_seconds=walls[1],
             bitwise_equal=True)


def stream_bounded_path(pipe: EammPipeline) -> None:
    """``render_stream`` over 4 segments of a 10 s clip: the seconds to its
    first and last payload, the payloads bitwise equal to
    ``render_uint8``."""
    four = with_options(pipe, overlap_segments=4)
    clip = clip_inputs(10.0, 3)
    info = {}
    out, _ = drive("render_stream bounded S=4", RENDER_KERNELS,
                   lambda: joined(four.render_stream(*clip, add_emo=False),
                                  info), 10.0, info)
    same_bits(out, four.render_uint8(*clip, add_emo=False),
              "bounded stream against render_uint8")
    emit("stream_vs_whole", path="bounded S=4", bitwise_equal=True)


def pinned_hold(pipe: EammPipeline, renders: int = 3) -> None:
    """Three 10 s renders held at once: each result is pageable memory,
    and the page-locked host memory PyTorch's caching host allocator owns
    (``torch.cuda.host_memory_stats``, where this torch has it) does not
    grow with the results held."""
    clip = clip_inputs(10.0, 3)
    held, pinned = [], []
    stats = getattr(torch.cuda, "host_memory_stats", None)
    for _ in range(renders):
        held.append(pipe.render_uint8(*clip, add_emo=False))
        if stats is not None:
            pinned.append(stats().get("allocated_bytes.current"))
    if any(torch.from_numpy(out).is_pinned() for out in held):
        raise AssertionError("a render handed out page-locked memory")
    emit("host_pinned", renders_held=renders, result_pinned=False,
         allocated_bytes=pinned or "not available")
    if pinned and pinned[-1] > pinned[0]:
        raise AssertionError(f"page-locked host memory grows with the "
                             f"results held: {pinned}")


def unbounded_path(pipe: EammPipeline, video: np.ndarray) -> None:
    """Chunks of STREAM_FRAMES: 4 s neutral and emotional (a handle, fewer
    frames than timesteps) streams within one count of the whole clip in
    float32; the peak memory of 10 s and 60 s streams in bfloat16 (60 s
    within 5% of 10 s) beside the whole 10 s clip's, and the 10 s stream
    against that clip; the length policy's route at 4 s and 20 s."""
    f32 = with_options(pipe, compute_dtype=torch.float32)
    f32_chunks = with_options(f32, segment_frames=STREAM_FRAMES)
    handle = f32.prepare_emotion(video)
    clip = clip_inputs(4.0, 2)
    for label, args in (("neutral", (None, False)),
                        ("emotional handle", (handle, True))):
        list(f32_chunks.render_stream(*clip_inputs(1.0, 100), *args))
        whole = f32.render_uint8(*clip, *args)
        info = {}
        out, _ = drive(f"unbounded f32 {label}", RENDER_KERNELS,
                       lambda: joined(f32_chunks.render_stream(*clip, *args),
                                      info), 4.0, info)
        diff = uint8_diff(out, whole)
        emit("unbounded_vs_whole", path=label, dtype="float32",
             clip_seconds=4.0, uint8_diff=diff)
        if out.shape != whole.shape or diff["max"] > 1.0:
            raise AssertionError(f"unbounded {label} strays from the whole "
                                 f"clip: {diff}")

    chunks = with_options(pipe, segment_frames=STREAM_FRAMES)
    list(chunks.render_stream(*clip_inputs(1.0, 100), add_emo=False))
    peaks, streamed = {}, None
    for seconds in (10.0, 60.0):
        clip = clip_inputs(seconds, 4)
        info = {}
        torch.cuda.reset_peak_memory_stats()
        out, _ = drive("unbounded bf16 neutral", RENDER_KERNELS,
                       lambda: joined(chunks.render_stream(
                           *clip, add_emo=False), info), seconds, info)
        peaks[f"stream_{seconds:g}s"] = torch.cuda.max_memory_allocated()
        streamed = streamed if streamed is not None else out
    torch.cuda.reset_peak_memory_stats()
    whole = pipe.render_uint8(*clip_inputs(10.0, 4), add_emo=False)
    peaks["whole_clip_10s"] = torch.cuda.max_memory_allocated()
    emit("memory", path="unbounded bf16 neutral", max_memory_allocated=peaks,
         ratio_60s_10s=peaks["stream_60s"] / peaks["stream_10s"])
    emit("unbounded_vs_whole", path="neutral", dtype="bfloat16",
         clip_seconds=10.0, uint8_diff=uint8_diff(streamed, whole))
    if peaks["stream_60s"] > 1.05 * peaks["stream_10s"]:
        raise AssertionError(f"the stream's memory grows with the clip: "
                             f"{peaks}")

    policy = with_options(pipe, segment_frames=STREAM_FRAMES,
                          stream_policy_frames=POLICY_FRAMES)
    info = {}
    for name, route in (("_render_segments", "whole clip"),
                        ("_render_stream_unbounded", "unbounded chunks")):
        method = getattr(policy, name)
        setattr(policy, name, lambda *a, m=method, r=route: (
            info.__setitem__("route", r), m(*a))[1])
    for seconds, want in ((4.0, "whole clip"), (20.0, "unbounded chunks")):
        clip = clip_inputs(seconds, 5)
        info.clear()
        drive(f"policy {POLICY_FRAMES} frames", RENDER_KERNELS, lambda: policy.render_uint8(*clip, add_emo=False), seconds,
              info)
        if info["route"] != want:
            raise AssertionError(f"{seconds} s took {info['route']}")


def batch_inputs(seed: int = 20):
    """N = len(BATCH_SECONDS) identities: sources, waveforms, poses."""
    clips = [clip_inputs(s, seed + i) for i, s in enumerate(BATCH_SECONDS)]
    return (np.stack([c[0] for c in clips]), [c[1] for c in clips],
            [c[2] for c in clips])


def batch_path(pipe: EammPipeline) -> dict:
    """``render_batch_uint8`` of 4 identities: in float32 each identity
    within one count of its own render; in bfloat16 ``render_batch_yuv420``
    in 2 overlapped segments bitwise equal to one.  Returns the wide and
    narrow warps' arguments on the batched path (N sources)."""
    sources, wavs, poses = batch_inputs()
    total = sum(BATCH_SECONDS)
    warm = batch_inputs(100)
    f32 = with_options(pipe, compute_dtype=torch.float32)
    f32.render_batch_uint8(*warm)                                # warm-up
    out, _ = drive("batch f32 N=4", RENDER_KERNELS,
                   lambda: f32.render_batch_uint8(sources, wavs, poses), total)
    for i in range(len(sources)):
        single = f32.render_uint8(sources[i], wavs[i], poses[i],
                                  add_emo=False)
        diff = uint8_diff(out[i, :len(single)], single)
        emit("batch_vs_single", identity=i, dtype="float32",
             frames=len(single), uint8_diff=diff)
        if diff["max"] > 1.0:
            raise AssertionError(f"identity {i} strays from its own render: "
                                 f"{diff}")
    yuv = with_options(pipe, transfer_format="yuv420")
    outs = []
    for S in (1, 2):
        p = with_options(yuv, overlap_segments=S)
        p.render_batch_yuv420(*warm)                             # warm-up
        planes, _ = drive(f"batch yuv420 bf16 N=4 S={S}", RENDER_KERNELS,
                          lambda: p.render_batch_yuv420(sources, wavs, poses),
                          total)
        outs.append(planes)
    same_bits(*outs, "batch S=2 against S=1")
    emit("batch_overlap_vs_single", segments=2, bitwise_equal=True)
    captured = capture_warps(
        lambda: pipe.render_batch_uint8(sources, wavs, poses))
    emit("batch_capture", Bi={k: v[0].shape[0] for k, v in captured.items()},
         shapes={k: [list(t.shape) for t in v] for k, v in captured.items()})
    if any(v[0].shape[0] != len(sources) for v in captured.values()):
        raise AssertionError("the batched warps did not read N sources")
    return captured


def capture_warps(render) -> dict:
    """The arguments (image, grid) that the first decode chunk of
    ``render()`` passes to the wide and narrow warps, cloned.  The models
    call the warps by their module attributes, which are wrapped for this
    one call."""
    from eamm_tpu_torch.models import dense_motion, generator
    spied = {"warp_narrow": (dense_motion, "grid_sample_narrow"),
             "warp_wide": (generator, "grid_sample_wide")}
    captured, originals = {}, {}

    def spy(name, fn):
        def call(image, grid, *args, **kw):
            captured.setdefault(name, (image.clone(), grid.clone()))
            return fn(image, grid, *args, **kw)
        return call

    for name, (module, attr) in spied.items():
        originals[name] = getattr(module, attr)
        setattr(module, attr, spy(name, originals[name]))
    try:
        render()
    finally:
        for name, (module, attr) in spied.items():
            setattr(module, attr, originals[name])
    return captured


def capture_warp_inputs(pipe: EammPipeline, seconds: float = 10.0,
                        seed: int = 3) -> dict:
    """``capture_warps`` of a neutral request."""
    return capture_warps(lambda: pipe.render_uint8(
        *clip_inputs(seconds, seed), add_emo=False))


def entry_points() -> dict:
    """The shared warp and the fused keypoint expectation through their
    own entry points (no model calls them)."""
    gen = torch.Generator(device="cuda").manual_seed(2)
    image, grid = warp_case(1, 32, (64, 64), 256, torch.float32, gen)
    pred, jmap, temp = kp_case(256, gen)
    _, launches = drive("entry points", ("warp_shared", "kp_expectation_fused"),
                        lambda: (warp_cuda.grid_sample_shared(image[0], grid),
                                 kpx.kp_expectation_fused(pred, jmap, temp,
                                                          True)))
    return launches


# ---------------------------------------------------------------- phase 6

def time_ms(fn, budget_s: float = 0.3) -> float:
    """Mean ms per call over enough back-to-back calls to fill the budget,
    by CUDA events, after warm-up."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    iters = int(min(500, max(5, budget_s / max(time.perf_counter() - t0,
                                                  1e-6))))
    return events_ms(fn, iters)


def events_ms(fn, iters: int) -> float:
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def graphed(fn, calls: int = 20):
    """``fn`` called ``calls`` times, captured in one CUDA graph after
    warm-up; returns (replay, calls).  A replay runs the captured launches
    back to back on the card with no host work between them, so its time
    is device time, whatever the caller's Python costs."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    return graph.replay, calls


def in_turns(fns: dict, rounds: int = 3, sample_s: float = 0.02) -> dict:
    """name -> (fn, calls per fn call), each timed in 2 * ``rounds``
    samples of about ``sample_s``, taken in turns (a, b, c, c, b, a per
    round); returns name -> {median, min, max} ms per call."""
    iters = {name: max(5, int(sample_s / (time_ms(fn, 0.01) * 1e-3)))
             for name, (fn, _) in fns.items()}
    order = list(fns) + list(fns)[::-1]
    samples = {name: [] for name in fns}
    for _ in range(rounds):
        for name in order:
            fn, calls = fns[name]
            samples[name].append(events_ms(fn, iters[name]) / calls)
    return {name: {"median": float(np.median(v)), "min": min(v),
                   "max": max(v)} for name, v in samples.items()}


def device_ms(fn) -> float:
    """Median device ms per call of ``fn`` (CUDA graph replays)."""
    return in_turns({"ms": graphed(fn)})["ms"]["median"]


def bound_ms(n_bytes: float, n_ops: float):
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def timings(captured: dict) -> dict:
    """Phase 6; the warps at the random grid and at ``captured``, the main
    path's arguments; the keypoint expectations as ``kp_timings``."""
    gen = torch.Generator(device="cuda").manual_seed(1)
    out = {}
    wide = captured["warp_wide"]
    for name, C, B, dtype, main in (
            ("warp_wide", 256, 32, torch.bfloat16, wide),
            ("warp_narrow", 3, 352, torch.bfloat16, captured["warp_narrow"]),
            ("warp_shared", 256, 32, torch.float32,
             (wide[0].float(), wide[1].float()))):
        wrapper, plain = KERNELS[name][:2]
        rows = {}
        for inputs, (image, grid) in (
                ("random", warp_case(1, B, (64, 64), C, dtype, gen)),
                ("captured", main)):
            args = (image[0], grid) if name == "warp_shared" else (image, grid)
            res = wrapper(*args)
            sink = torch.empty_like(res)
            nchw = image.permute(0, 3, 1, 2).expand(len(grid), -1, -1, -1)
            fns = {"ms": lambda: wrapper(*args),
                   "library_ms": lambda: F.grid_sample(
                       nchw, grid, mode="bilinear", padding_mode="zeros",
                       align_corners=False),
                   "store_ms": lambda: warp_cuda.store_only(sink)}
            device = in_turns({k: graphed(f) for k, f in fns.items()})
            eager = in_turns({"call_ms": (fns["ms"], 1),
                              "library_call_ms": (fns["library_ms"], 1),
                              "store_call_ms": (fns["store_ms"], 1)})
            rows[inputs] = {**device, **eager,
                            "plain_ms": time_ms(lambda: plain(*args))}
        out[name] = {
            "ms": rows["random"]["ms"]["median"],
            "plain_ms": rows["random"]["plain_ms"],
            "library_ms": rows["random"]["library_ms"]["median"],
            "bound": bound_ms(nbytes(image, grid, res),
                              8 * res.numel()),    # 4 FMA per value
            "timing": rows,
        }
    return {**out, **kp_timings(gen)}


def kp_bound(pred: torch.Tensor, jmap: torch.Tensor, heat: bool):
    """The keypoint expectation's bound: each input read once, 6 floats
    written per row (and the heatmap in pred's dtype); ~16 operations per
    pixel (divide, exp, 7 multiply-adds), one more with the heatmap."""
    B, K, h, w = pred.shape
    P = B * K * h * w
    n_bytes = nbytes(pred, jmap) + 24 * B * K + (nbytes(pred) if heat else 0)
    return bound_ms(n_bytes, (16 + heat) * P)


def kp_timings(gen: torch.Generator) -> dict:
    """The fused keypoint expectation three ways (float32 with and without
    the heatmap, bfloat16 with it) and K3 on the same float32 inputs, all
    in the same turns, each with its own bound."""
    f32 = kp_case(256, gen)
    variants = {"f32_heat": (f32, True), "f32_no_heat": (f32, False),
                "bf16_heat": (kp_case(256, gen, dtype=torch.bfloat16), True)}
    fused = kpx.kp_expectation_fused
    fns = {name: graphed(lambda a=args, hm=hm: fused(*a, hm))
           for name, (args, hm) in variants.items()}
    fns["kp_expectation_f32"] = graphed(lambda: kpx.kp_expectation(*f32))
    times = in_turns(fns)
    timing = {}
    for name, t in times.items():
        args, hm = variants.get(name, (f32, False))
        bound, by = kp_bound(*args[:2], hm)
        timing[name] = {**t, "bound_ms": bound, "bound_by": by,
                        "share": bound / t["median"]}
    return {
        "kp_expectation": {
            "ms": times["kp_expectation_f32"]["median"],
            "plain_ms": time_ms(lambda: kpx.kp_expectation_plain(*f32)),
            "library_ms": None, "bound": kp_bound(*f32[:2], False)},
        "kp_expectation_fused": {
            "ms": times["f32_heat"]["median"],
            "plain_ms": time_ms(lambda: kpx.kp_expectation_fused_plain(
                *f32, True)),
            "library_ms": None, "bound": kp_bound(*f32[:2], True),
            "timing": timing,
            "plan": dataclasses.asdict(kpx.fused_launch_plan(
                *f32[:2], True))},
    }


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    card = card_line()
    print(card, flush=True)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    emit("device", card=card, name=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(), torch=torch.__version__,
         cuda=torch.version.cuda,
         cudnn_allow_tf32=torch.backends.cudnn.allow_tf32,
         matmul_allow_tf32=torch.backends.cuda.matmul.allow_tf32)

    t0 = time.perf_counter()
    builds = kernels.build()
    emit("build", wall_seconds=time.perf_counter() - t0,
         sources={b.name: {"seconds": b.seconds,
                           "ptxas": [line.strip() for line in
                                     b.ptxas.splitlines() if "ptxas" in line]}
                  for b in builds})

    worst = parity(parity_cases())
    emit("cpu_vs_card", **cpu_vs_device("cuda"))
    emit("cpu_vs_card", **cpu_vs_device("cuda", emotion=True))
    opts = PipelineOptions(frame_chunk=32, time_bucket=32,
                           compute_dtype=torch.bfloat16, device="cuda")
    pipe, _ = main_path(opts)
    captured = capture_warp_inputs(pipe)
    worst = parity(captured_cases(captured), worst)
    counts = emotional_path(pipe)
    video = emotion_clip(EMOTION_FRAMES, 7)
    yuv420_path(pipe, video)
    overlap_path(pipe, video)
    stream_bounded_path(pipe)
    pinned_hold(pipe)
    unbounded_path(pipe, video)
    worst = parity(captured_cases(batch_path(pipe)), worst)
    entry = entry_points()
    times = timings(captured)

    # whose launches each row counts
    source_of = {name: ("emotional linear_3 frames 10 s", counts["frames"])
                 for name in RENDER_KERNELS}
    source_of["kp_expectation"] = ("emotional map frames 4 s", counts["map"])
    for name in ("warp_shared", "kp_expectation_fused"):
        source_of[name] = ("entry points", entry)
    by_path = {name: {(f"{r['path']} {r['clip_seconds']:g} s"
                       if "clip_seconds" in r else r["path"]):
                      r["launches"][name] for r in REQUESTS}
               for name in KERNELS}
    rows = []
    for name, (_, _, source, replaces) in KERNELS.items():
        t = times[name]
        path, launches = source_of[name]
        rows.append({"name": name, "route": "cuda", "source": source,
                     "replaces": replaces, "path": path,
                     "launches": launches[name],
                     "max_abs_err": worst[name], "ms": t["ms"],
                     "plain_ms": t["plain_ms"], "bound_ms": t["bound"][0],
                     "bound_by": t["bound"][1], "library_ms": t["library_ms"],
                     "launches_by_path": by_path[name],
                     **{k: t[k] for k in ("timing", "plan") if k in t}})
    print(card_line(), flush=True)
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
