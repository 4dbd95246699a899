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
   the CPU (plain versions) and on the card (kernels) in float32 at
   EMOTION_TINY_CONFIG (TINY_CONFIG's render models), neutral and
   emotional (5 emotion frames); per-frame mean |difference| max < 1e-2,
   mean < 3e-3.
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
5b. serving, at FULL_CONFIG from the main path's weights:
   - checkpoints: the five models saved as the reference's three
     ``.pth.tar`` files (a ``module.`` prefix, an optimizer's state and an
     epoch in the FOMM file, Emotion_k's ``final_4`` stack in the emotion
     file), each passed by the preflight, loaded back through
     ``from_torch_checkpoints``, every tensor bitwise the original;
   - the server of ``cli/serve.py`` (``main``, or ``serve`` with the
     config dict where PyYAML does not import) on the card over HTTP on
     loopback: bf16, yuv420, max_batch 4, max_delay 50 ms, segment_frames
     128, stream policy 384 frames, warmed by --warmup_seconds 4; from
     concurrent client threads 8 neutral 4 s requests (two dispatches of
     4), then 3 (one dispatch padded to 4), then at once 2 emotional 4 s
     requests through a ``PUT /emotion`` id, one with raw uint8 frames, a
     10 s ``/render_stream`` and a 20 s request (the unbounded chunks).
     Every call the worker made is made again on this thread and held to
     its result bit for bit, each client's payload to its part of it; the
     stats' dispatches and occupancy as predicted; requests and frames per
     second, latency per route (p50, max), the stream's first segment,
     peak device memory, and a padded (3 + 1) against a full dispatch of
     4 (wall ms in turns); K1-K3 launches per route;
   - the demo of ``cli/demo.py`` on the checkpoints (--bf16 --no_crop
     --no_align, a 4 s wav, a pose track and a uint8 emotion clip as
     files), as is and with --adapt_scale: neutral and emotional frames
     bitwise ``render_uint8`` on the demo's pipeline, the adapt_scale
     scale within 1e-6 of the convex-hull ratio (and the keypoints'
     difference between two calls), launches per run.
7. the frozen artifact (``eamm_tpu_torch/infer/export.py``), after 5b:
   the main path's models at FULL_CONFIG, bfloat16, yuv420, frame_chunk
   32, exported on the card at batch 4, one frame bucket of 64 (the 2 s
   requests' 50 frames), emotion bucket 32, 2 stream segments and
   unbounded chunks of 64 frames with the length policy at 64 (11
   programs; each program's export seconds, the file's bytes); served
   by ``eamm-torch-serve --artifact`` (``cli/serve.py`` ``main``), whose
   load of the file is timed; every program run on inputs the artifact's
   host side makes from seeded requests and held bitwise to the live
   pipeline's function on the same inputs, with K1-K3 launches per
   program; each route on the server's ``ArtifactPipeline`` (a batch of 4
   clips of 2 s, an emotional 2 s clip with 20 raw frames, a 2 s stream,
   a 5 s clip through the unbounded chunks) driven with launch counts
   (``artifact <route>`` requests: each of K1-K3 must launch); the batch
   call bitwise the live pipeline's same call, both timed in turns (wall
   ms, artifact, live, live, artifact; three rounds); then the same kinds
   of request at once from client threads over HTTP, every call the
   worker made made again and held to its result bit for bit, each
   client's payload to its part of it, with latencies and the peak
   device memory while serving beside phase 5b's.
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
   both replayed and eager (``call_ms``, through the ``eamm::``
   operator; ``launcher_call_ms``, the wrapper's own launch without the
   operator's dispatch, what a call cost before the kernels were
   operators); the store-only kernel writes the output's bytes and
   nothing else, the card's write ceiling.  The fused
   keypoint expectation is timed three ways (float32 with and without the
   heatmap, bfloat16 with it), each with its own bound, in the same turns
   as K3 on the same float32 inputs (``timing`` in its row, with the
   launch ``plan`` the wrapper makes for the first); K3's and K5's eager
   call through the operator and through their CUDA implementation
   called directly, in turns (``*call_ms`` in ``timing``).
   The plain versions are timed eager.

Then the card's name and power limit, the ``{"kernels": [...]}`` line
(with the path whose launches each row counts, the launches on every
request by path and on every serving route), and last
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import collections
import dataclasses
import json
import os
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np
import torch
import torch.nn.functional as F

from eamm_tpu_torch import config as cfg
from eamm_tpu_torch import kernels
from eamm_tpu_torch.infer import EammPipeline, PipelineOptions
from eamm_tpu_torch.infer.pipeline import reset_parameters
from eamm_tpu_torch.ops.colorspace import yuv420_to_rgb
from eamm_tpu_torch.ops.mfcc import num_windows_for_samples
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

def cpu_vs_device(device: str = "cuda", seed: int = 0) -> dict:
    """The same seeded pipeline at EMOTION_TINY_CONFIG (TINY_CONFIG's four
    render models, drawn before the emotion model) built on the CPU and on
    ``device``; the same 1 s clip rendered on both, neutral and emotional
    with 5 emotion frames -> {'neutral', 'emotional'} results; raises
    unless each render's per-frame mean |difference| has max < 1e-2 and
    mean < 3e-3."""
    opts = dict(frame_chunk=8, time_bucket=8)
    cpu = EammPipeline.from_random(EMOTION_TINY_CONFIG, seed,
                                   PipelineOptions(device="cpu", **opts))
    dev = EammPipeline.from_random(EMOTION_TINY_CONFIG, seed,
                                   PipelineOptions(device=device, **opts))
    src, wav, pose = clip_inputs(1.0, seed)
    results = {}
    for name, video in (("neutral", None),
                        ("emotional", emotion_clip(5, seed))):
        emotion = video is not None
        a = cpu.render(src, wav, pose, video, add_emo=emotion)
        b = dev.render(src, wav, pose, video, add_emo=emotion)
        if a.shape != b.shape:
            raise AssertionError(f"shapes differ: {a.shape} vs {b.shape}")
        l1 = np.abs(a - b).mean(axis=(1, 2, 3))
        result = {"emotion": emotion, "frames": int(a.shape[0]),
                  "l1_max": float(l1.max()), "l1_mean": float(l1.mean())}
        if not (l1.max() < 1e-2 and l1.mean() < 3e-3):
            raise AssertionError(f"CPU vs {device} render differs: {result}")
        results[name] = result
    return results


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


# ------------------------------------------------ phase 5b: serving

SERVE_SECONDS = 4.0             # the neutral and emotional requests
SERVE_STREAM_SECONDS = 10.0     # one POST /render_stream
SERVE_LONG_SECONDS = 20.0       # 500 frames, past the 384-frame policy
SERVE_ARGV = ["--host", "127.0.0.1", "--port", "0", "--max_batch", "4",
              "--max_delay_ms", "50", "--transfer_format", "yuv420",
              "--segment_frames", "128", "--stream_policy_frames", "384",
              "--warmup_seconds", "4"]
# the demo config's mouth mask (configs/demo.yaml), the augmentation the
# demo draws the emotion frames through
DEMO_AUGMENTATION = {"crop_mouth_param": {"center_x": 135, "center_y": 190,
                                          "mask_width": 100,
                                          "mask_height": 60}}
SERVE_ROUTES = ("coalesced", "padded", "emotional_id", "emotional_uint8",
                "stream", "unbounded", "demo", "demo_adapt_scale")


def importable(name: str) -> bool:
    try:
        __import__(name)
    except ImportError:
        return False
    return True


def save_checkpoints(models: dict, directory: str) -> dict:
    """The five models as the reference's three ``.pth.tar`` files, as the
    reference trainer leaves them: the FOMM file's generator under
    DataParallel's ``module.`` prefix, with an optimizer's state and an
    epoch number; the emotion file with Emotion_k's ``final_4`` stack ->
    {'fomm', 'audio', 'emo'} paths."""
    sd = {k: {n: t.cpu() for n, t in m.state_dict().items()}
          for k, m in models.items()}
    emo = dict(sd["emo_detector"])
    for i in (0, 3):
        for p in ("weight", "bias"):
            emo[f"final_4.{i}.{p}"] = emo[f"final.{i}.{p}"] + 1.0
    opt = torch.optim.Adam(models["kp_detector"].parameters())
    files = {
        "fomm": {"generator": {f"module.{k}": v
                               for k, v in sd["generator"].items()},
                 "kp_detector": sd["kp_detector"],
                 "optimizer_kp_detector": opt.state_dict(), "epoch": 7},
        "audio": {"audio_feature": sd["audio_feature"],
                  "kp_detector_a": sd["kp_detector_a"]},
        "emo": {"emo_detector": emo},
    }
    paths = {}
    for name, ckpt in files.items():
        paths[name] = os.path.join(directory, f"{name}.pth.tar")
        torch.save(ckpt, paths[name])
    return paths


def checkpoint_path(pipe: EammPipeline, directory: str,
                    device: str = "cuda") -> dict:
    """Save ``pipe``'s models as the reference's checkpoints, check each
    with the preflight (ok, nothing fatal), load them back through
    ``from_torch_checkpoints`` and hold every state_dict to the original's
    bit for bit -> the paths."""
    from eamm_tpu_torch.compat.preflight import check_state_dict
    paths = save_checkpoints(pipe.models, directory)
    reports = {name: check_state_dict(path) for name, path in paths.items()}
    loaded = EammPipeline.from_torch_checkpoints(
        FULL_CONFIG, paths["fomm"], paths["audio"], paths["emo"],
        PipelineOptions(device=device))
    tensors = 0
    for name, model in pipe.models.items():
        ref, got = model.state_dict(), loaded.models[name].state_dict()
        if ref.keys() != got.keys() or not all(
                torch.equal(ref[k], got[k]) for k in ref):
            raise AssertionError(f"{name}: the loaded state_dict differs")
        tensors += len(ref)
    emit("checkpoints", files={k: os.path.getsize(p)
                               for k, p in paths.items()},
         preflight={k: {"ok": r.ok, "fatal": r.fatal,
                        "modules": [m.name for m in r.modules],
                        "skipped": r.skipped} for k, r in reports.items()},
         ignored_keys=loaded.ignored_keys, tensors_equal=tensors)
    if not all(r.ok and not r.fatal for r in reports.values()):
        raise AssertionError(f"preflight: {[str(r) for r in reports.values()]}")
    return paths


class Recorder:
    """Wraps the render methods the server calls on ``pipe`` (instance
    attributes shadow the class's): each call's method, arguments, result,
    wall seconds and kernel launches.  Only the server's worker thread
    launches kernels while it runs, so a call's launch delta is its own."""

    METHODS = ("render_batch_yuv420", "render_yuv420")

    def __init__(self, pipe: EammPipeline):
        self.pipe, self.calls = pipe, []
        self.original = {m: getattr(pipe, m)
                         for m in (*self.METHODS, "render_stream")}
        for m in self.METHODS:
            setattr(pipe, m, self._wrap(m))
        pipe.render_stream = self._wrap_stream

    def _record(self, method, args, kwargs, result, before, t0):
        after = launch_counts()
        self.calls.append({"method": method, "args": args, "kwargs": kwargs,
                           "result": result,
                           "wall": time.perf_counter() - t0,
                           "launches": {k: after[k] - before[k]
                                        for k in after}})

    def _wrap(self, method):
        def call(*args, **kwargs):
            before, t0 = launch_counts(), time.perf_counter()
            out = self.original[method](*args, **kwargs)
            self._record(method, args, kwargs, out, before, t0)
            return out
        return call

    def _wrap_stream(self, *args, **kwargs):
        before, t0 = launch_counts(), time.perf_counter()
        parts = []
        for start, payload in self.original["render_stream"](*args,
                                                              **kwargs):
            parts.append((start, payload))
            yield start, payload
        self._record("render_stream", args, kwargs, parts, before, t0)

    def replay(self, call):
        """The recorded call made again, on this thread."""
        out = self.original[call["method"]](*call["args"], **call["kwargs"])
        return list(out) if call["method"] == "render_stream" else out


def _planes(payload) -> tuple:
    return tuple(payload[k] for k in ("y", "u", "v"))


def post(url: str, body: bytes, method: str = "POST"):
    """One HTTP request -> (the decoded npz or JSON, seconds)."""
    import urllib.request
    from eamm_tpu_torch.serve_http import decode_response
    t0 = time.perf_counter()
    with urllib.request.urlopen(urllib.request.Request(
            url, data=body, method=method), timeout=600) as resp:
        raw = resp.read()
    seconds = time.perf_counter() - t0
    if resp.headers.get("Content-Type") == "application/json":
        return json.loads(raw), seconds
    return decode_response(raw), seconds


def post_stream(url: str, body: bytes):
    """POST /render_stream -> (segments, seconds to the first, seconds)."""
    import urllib.request
    from eamm_tpu_torch.serve_http import iter_stream
    t0 = time.perf_counter()
    segs, first = [], None
    with urllib.request.urlopen(urllib.request.Request(
            url, data=body, method="POST"), timeout=600) as resp:
        for seg in iter_stream(resp):
            first = first or time.perf_counter() - t0
            segs.append(seg)
    return segs, first, time.perf_counter() - t0


def concurrently(jobs: dict) -> tuple[dict, float]:
    """name -> zero-argument callable, all started at once behind a
    barrier, each on its own thread -> (name -> its result, wall
    seconds); raises the first failure."""
    barrier = threading.Barrier(len(jobs) + 1)
    results, errors = {}, []

    def run(name, fn):
        barrier.wait()
        try:
            results[name] = fn()
        except BaseException as e:          # re-raised on the main thread
            errors.append(e)

    threads = [threading.Thread(target=run, args=item) for item in
               jobs.items()]
    for t in threads:
        t.start()
    barrier.wait()
    t0 = time.perf_counter()
    for t in threads:
        t.join()
    if errors:
        raise errors[0]
    return results, time.perf_counter() - t0


def served_by(calls: list, wav: np.ndarray) -> tuple[dict, int | None]:
    """The recorded call that served the request of ``wav``, and its row
    in a batch call (None for a call of one clip)."""
    for call in calls:
        if call["method"] == "render_batch_yuv420":
            for i, w in enumerate(call["args"][1]):
                if np.array_equal(w, wav):
                    return call, i
        elif np.array_equal(call["args"][1], wav):
            return call, None
    raise AssertionError("no recorded call served the request")


def serving_path(paths: dict, device: str = "cuda") -> dict:
    """The server of ``cli/serve.py`` on the card, over HTTP on loopback,
    built from the checkpoints and warmed by --warmup_seconds; three
    rounds of concurrent client threads: 8 neutral 4 s requests (two
    coalesced dispatches of 4), 3 neutral 4 s requests (one dispatch
    padded to 4), then 2 emotional 4 s requests through a ``PUT
    /emotion`` id, one with raw uint8 frames, a 10 s stream and a 20 s
    request (the unbounded chunks) at once.  Every result is held bit for
    bit to the same call made again on this thread, and each client's
    payload to its part of it -> route -> K1-K3 launches."""
    from eamm_tpu_torch.cli import serve as serve_cli
    from eamm_tpu_torch.serve_http import (encode_emotion_registration,
                                           encode_request)
    argv = ["--config", paths.get("config") or "", "--checkpoint",
            paths["fomm"], "--audio_checkpoint", paths["audio"],
            "--emo_checkpoint", paths["emo"], *SERVE_ARGV,
            *(["--cpu"] if device == "cpu" else [])]
    fronts, stop = [], threading.Event()
    ready = threading.Event()

    def on_ready(front):
        fronts.append(front)
        ready.set()

    def run():
        if paths.get("config"):
            serve_cli.main(argv, stop_event=stop, ready=on_ready)
        else:             # no PyYAML: what main runs after reading the file
            serve_cli.serve(serve_cli.build_parser().parse_args(argv),
                            FULL_CONFIG, stop_event=stop, ready=on_ready)

    t0 = time.perf_counter()
    thread = threading.Thread(target=run, daemon=True)
    thread.start()
    while not ready.wait(1.0):
        if not thread.is_alive():
            raise AssertionError("the server did not start")
    front = fronts[0]
    server, pipe = front.server, front.server.pipeline
    emit("serve_setup", seconds=time.perf_counter() - t0, url=front.url,
         via="main" if paths.get("config") else "serve",
         options=dataclasses.asdict(pipe.options) | {
             "compute_dtype": str(pipe.options.compute_dtype)})
    rec = Recorder(pipe)
    url = front.url
    arrivals = []                # when each /render reached the server
    submit = server.submit

    def timed_submit(*args, **kwargs):
        arrivals.append(time.perf_counter())
        return submit(*args, **kwargs)

    server.submit = timed_submit
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    reports, clients = {}, {}
    try:
        for name, n, seed in (("coalesced", 8, 300), ("padded", 3, 320)):
            server.reset_stats()
            start, arrived = len(rec.calls), len(arrivals)
            reqs = {f"{name}{i}": clip_inputs(SERVE_SECONDS, seed + i)
                    for i in range(n)}
            bodies = {k: encode_request(*r) for k, r in reqs.items()}
            out, wall = concurrently({
                k: (lambda b=b: post(url + "/render", b))
                for k, b in bodies.items()})
            stats, _ = post(url + "/stats", None, "GET")
            times = sorted(arrivals[arrived:])
            reports[name] = {"requests": n, "wall_seconds": wall,
                             "stats": stats,
                             "calls": len(rec.calls) - start,
                             "group_sizes": [
                                 len(c["args"][0]) - sum(
                                     np.array_equal(x, c["args"][0][0])
                                     for x in c["args"][0][1:])
                                 for c in rec.calls[start:]],
                             "arrival_offsets_ms": [
                                 1e3 * (t - times[0]) for t in times]}
            clients[name] = (reqs, out, rec.calls[start:])
            want = (2, 4.0) if n == 8 else (1, 3.0)
            if (stats["dispatches"], stats["mean_batch_occupancy"]) != want:
                raise AssertionError(f"{name}: {reports[name]}, expected "
                                     f"{want}")
        server.reset_stats()
        start = len(rec.calls)
        video = emotion_clip(EMOTION_FRAMES, 7)
        registered, _ = post(url + "/emotion", encode_emotion_registration(
            "style", video), "PUT")
        u8 = (emotion_clip(EMOTION_FRAMES, 8) * 255).astype(np.uint8)
        mixed = {"emotional_id.0": clip_inputs(SERVE_SECONDS, 340),
                 "emotional_id.1": clip_inputs(SERVE_SECONDS, 341),
                 "emotional_uint8": clip_inputs(SERVE_SECONDS, 342),
                 "stream": clip_inputs(SERVE_STREAM_SECONDS, 343),
                 "unbounded": clip_inputs(SERVE_LONG_SECONDS, 344)}
        bodies = {k: encode_request(*r, emotion_id="style")
                  for k, r in mixed.items() if k.startswith("emotional_id")}
        bodies["emotional_uint8"] = encode_request(
            *mixed["emotional_uint8"], transformed=u8)
        bodies["unbounded"] = encode_request(*mixed["unbounded"])
        stream_body = encode_request(*mixed["stream"])
        jobs = {k: (lambda b=b: post(url + "/render", b))
                for k, b in bodies.items()}
        jobs["stream"] = lambda: post_stream(url + "/render_stream",
                                             stream_body)
        out, wall = concurrently(jobs)
        stats, _ = post(url + "/stats", None, "GET")
        reports["mixed"] = {"requests": len(jobs), "wall_seconds": wall,
                            "stats": stats, "emotion_frames":
                            registered["frames"],
                            "calls": len(rec.calls) - start}
        clients["mixed"] = (mixed, out, rec.calls[start:])
        if (stats["dispatches"], stats["mean_batch_occupancy"]) != (5, 1.0):
            raise AssertionError(f"mixed: {stats}, expected 5 singletons")
        peak = PEAKS["serving"] = torch.cuda.max_memory_allocated()
        launches = launch_counts()
    finally:
        stop.set()
        thread.join(120)
    if thread.is_alive():
        raise AssertionError("the server did not stop")
    return hold_served(rec, clients, reports, peak, launches)


def hold_served(rec: Recorder, clients: dict, reports: dict, peak: int,
                launches: dict) -> dict:
    """Every recorded call made again on this thread, bitwise its recorded
    result; each client's payload bitwise its part of it; the latency and
    throughput lines; the padded against the full dispatch -> route ->
    K1-K3 launches."""
    for call in rec.calls:
        again = rec.replay(call)
        if call["method"] == "render_stream":
            for (s0, p0), (s1, p1) in zip(call["result"], again, strict=True):
                same_bits(p0, p1, f"stream segment {s0}")
        else:
            same_bits(call["result"], again, call["method"])
    by_route, latency, frames_total = {}, {}, 0
    for round_name, (reqs, out, calls) in clients.items():
        frames_round = 0
        for key, req in reqs.items():
            route = key.split(".")[0] if round_name == "mixed" \
                else round_name
            call, row = served_by(calls, req[1])
            T = num_windows_for_samples(len(req[1]))
            if route == "stream":
                segs, first, seconds = out[key]
                got = tuple(np.concatenate([s[k] for s in segs])
                            for k in ("y", "u", "v"))
                want = tuple(np.concatenate([p[i] for _, p in
                                             call["result"]])
                             for i in range(3))
                latency.setdefault("stream_first_segment", []).append(first)
            else:
                payload, seconds = out[key]
                got = _planes(payload)
                if row is not None:
                    want = tuple(p[row, :T] for p in call["result"])
                else:
                    want = tuple(p[:T] for p in call["result"])
            same_bits(got, want, f"{key}: client payload")
            frames_out(got)
            frames_round += T
            latency.setdefault(route, []).append(seconds)
            by_route.setdefault(route, call["launches"])
        frames_total += frames_round
        reports[round_name].update(
            frames=frames_round,
            requests_per_s=reports[round_name]["requests"]
            / reports[round_name]["wall_seconds"],
            frames_per_s=frames_round / reports[round_name]["wall_seconds"])
    # the dispatches' own calls, by what they did
    padded = [c for c in clients["padded"][2]
              if c["method"] == "render_batch_yuv420"]
    full = [c for c in clients["coalesced"][2]
            if c["method"] == "render_batch_yuv420"]
    if len(padded) != 1 or len(full) != 2:
        raise AssertionError(f"batch calls: {len(padded)} padded, "
                             f"{len(full)} full")
    srcs = padded[0]["args"][0]
    distinct = [s for i, s in enumerate(srcs)
                if not any(np.array_equal(s, t) for t in srcs[:i])]
    if len(srcs) != 4 or len(distinct) != 3 or \
            not np.array_equal(srcs[3], srcs[0]):
        raise AssertionError("the padded group is not 3 requests and a "
                             "replica of the first")
    by_route["coalesced"] = full[0]["launches"]
    by_route["padded"] = padded[0]["launches"]
    for route, counts in by_route.items():
        missing = [k for k in RENDER_KERNELS if counts[k] <= 0]
        if missing:
            raise AssertionError(f"{route}: not launched: {missing}")
    # one padded (3 + 1 replica) and one full dispatch of 4, wall ms each
    # (they end on the host), taken in turns
    walls = {"padded_3_plus_1": [], "full_4": []}
    for _ in range(3):
        for name in ("padded_3_plus_1", "full_4", "full_4",
                     "padded_3_plus_1"):
            args = (padded if name.startswith("padded") else full)[0]["args"]
            t0 = time.perf_counter()
            rec.original["render_batch_yuv420"](*args)
            walls[name].append(1e3 * (time.perf_counter() - t0))
    turns = {k: {"median": float(np.median(v)), "min": min(v), "max": max(v),
                 "real_requests": 3 if k.startswith("padded") else 4}
             for k, v in walls.items()}
    emit("serving", rounds=reports, peak_memory_allocated=peak,
         launches=launches,
         latency_seconds={k: {"p50": float(np.median(v)), "max": max(v),
                              "n": len(v)} for k, v in latency.items()},
         dispatch_wall_ms=turns,
         dispatch_calls=dict(collections.Counter(
             c["method"] for c in rec.calls)),
         requests_per_s=sum(r["requests"] for r in reports.values())
         / sum(r["wall_seconds"] for r in reports.values()),
         frames_per_s=frames_total
         / sum(r["wall_seconds"] for r in reports.values()))
    return by_route


def demo_path(paths: dict, device: str = "cuda") -> dict:
    """``cli/demo.py`` on the checkpoints at --bf16 --no_crop --no_align,
    a 4 s 16 kHz wav, a [100, 7] pose track and a 50-frame uint8 emotion
    clip as files, once as is and once with --adapt_scale: through
    ``main`` where PyYAML imports, else through the functions ``main``
    calls after reading the config.  The neutral and emotional frames are
    bitwise ``render_uint8`` on the pipeline the demo built; the
    adapt_scale render's scale within 1e-6 (relative) of sqrt(area) of the
    source keypoints' convex hull over that of the first audio keypoints,
    from two further keypoint stages, each of which ``movement_scale``
    gives exactly -> route -> K1-K3 launches."""
    import random

    from scipy.io import wavfile

    from eamm_tpu_torch.cli import demo
    from eamm_tpu_torch.ops.mfcc import audio_to_mfcc_windows
    from eamm_tpu_torch.ops.motion import convex_hull_area
    d = paths["dir"]
    src, wav, _ = clip_inputs(SERVE_SECONDS, 360)
    files = {k: os.path.join(d, f) for k, f in (
        ("source", "source.npy"), ("wav", "speech.wav"),
        ("pose", "pose.npy"), ("emotion", "emotion.npy"))}
    np.save(files["source"], src)
    wavfile.write(files["wav"], 16000, (np.clip(wav, -1, 1) * 32767)
                  .astype(np.int16))
    np.save(files["pose"], np.random.RandomState(361).randn(100, 7)
            .astype(np.float32))
    np.save(files["emotion"], (emotion_clip(EMOTION_FRAMES, 362) * 255)
            .astype(np.uint8))
    config = {**FULL_CONFIG,
              "dataset_params": {"augmentation_params": DEMO_AUGMENTATION}}
    argv = ["--config", paths.get("demo_config") or "", "--checkpoint",
            paths["fomm"], "--audio_checkpoint", paths["audio"],
            "--emo_checkpoint", paths["emo"], "--source_image",
            files["source"], "--in_file", files["wav"], "--pose_file",
            files["pose"], "--driving_video", files["emotion"],
            "--result_path", os.path.join(d, "result"), "--no_crop",
            "--no_align", "--bf16", *(["--cpu"] if device == "cpu" else [])]
    by_route = {}
    for route, extra in (("demo", []), ("demo_adapt_scale",
                                        ["--adapt_scale"])):
        built = []
        build = demo.build_pipeline
        demo.build_pipeline = lambda *a: built.append(build(*a)) or built[0]
        np.random.seed(363)
        random.seed(363)
        torch.cuda.synchronize()
        reset_launch_counts()
        t0 = time.perf_counter()
        try:
            if paths.get("demo_config"):
                out = demo.main(argv + extra)
            else:
                opt = demo.build_parser().parse_args(argv + extra)
                out = demo.run_demo(demo.build_pipeline(opt, config),
                                    *demo.load_inputs(opt), opt, config)
        finally:
            demo.build_pipeline = build
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        by_route[route] = launch_counts()
        pipe = built[0]
        opt = demo.build_parser().parse_args(argv + extra)
        s, w, p, _ = demo.load_inputs(opt)
        same_bits(out["neutral"], pipe.render_uint8(s, w, p, add_emo=False),
                  f"{route} neutral")
        same_bits(out["emotion"], pipe.render_uint8(s, w, p,
                                                    out["transformed"]),
                  f"{route} emotional")
        info = {"frames": int(len(out["emotion"])), "wall_seconds": wall,
                "outputs": sorted(os.listdir(opt.result_path)),
                "device": str(pipe.device),
                "compute_dtype": str(pipe.options.compute_dtype)}
        if extra:
            # the hull ratio of the source and first audio keypoints, from
            # two more keypoint stages (the card may round a keypoint
            # differently from one call to the next)
            T, source, wv, ps = pipe._prepare(s, w, p)
            ratios, kps = [], []
            for _ in range(2):
                kp_s, _, kp_initial = pipe.audio_keypoints(
                    source, audio_to_mfcc_windows(wv)[:ps.shape[0]], ps)
                src_area = convex_hull_area(
                    kp_s["value"].float().cpu().numpy())
                drv_area = convex_hull_area(
                    kp_initial["value"].float().cpu().numpy())
                ratios.append(float(np.sqrt(src_area) / np.sqrt(drv_area)))
                kps.append(torch.cat([kp_s["value"], kp_initial["value"]]))
                if pipe.movement_scale(kp_s, kp_initial) != ratios[-1]:
                    raise AssertionError("movement_scale is not the hull "
                                         "ratio of its keypoints")
            rel = abs(out["movement_scale"] - ratios[0]) / ratios[0]
            info.update(movement_scale=out["movement_scale"],
                        hull_ratio_scale=ratios, relative_difference=rel,
                        keypoints_max_abs_difference_between_calls=float(
                            (kps[0] - kps[1]).abs().max()))
            if rel > 1e-6:
                raise AssertionError(f"adapt_scale: {out['movement_scale']}"
                                     f" against the hull ratio {ratios}")
        emit("demo", route=route, launches=by_route[route], **info)
        missing = [k for k in RENDER_KERNELS if by_route[route][k] <= 0]
        if missing:
            raise AssertionError(f"{route}: not launched: {missing}")
    return by_route


def serving_phase(pipe: EammPipeline, device: str = "cuda") -> dict:
    """Phase 5b: checkpoints, the server, the demo, on ``device`` -> route
    -> K1-K3 launches."""
    have = {name: importable(name) for name in ("yaml", "imageio")}
    emit("optional_imports", **have)
    with tempfile.TemporaryDirectory() as d:
        paths = checkpoint_path(pipe, d, device)
        paths["dir"] = d
        if have["yaml"]:
            import yaml
            for key, config in (("config", FULL_CONFIG), ("demo_config", {
                    **FULL_CONFIG, "dataset_params": {
                        "augmentation_params": DEMO_AUGMENTATION}})):
                paths[key] = os.path.join(d, f"{key}.yaml")
                with open(paths[key], "w") as f:
                    yaml.safe_dump(config, f)
        by_route = serving_path(paths, device)
        by_route.update(demo_path(paths, device))
    if set(by_route) != set(SERVE_ROUTES):
        raise AssertionError(f"serving routes: {sorted(by_route)}")
    return by_route


# ---------------------------------------------------------------- phase 7

# the artifact's frame bucket (the 2 s requests' 50 frames ride it), its
# unbounded chunk and length policy, its segments, its emotion bucket
ARTIFACT_FRAMES = 64
ARTIFACT_SEGMENTS = 2
ARTIFACT_EMO_FRAMES = 32
ARTIFACT_SECONDS = 2.0
ARTIFACT_LONG_SECONDS = 5.0     # 125 frames: two unbounded chunks
ARTIFACT_ROUTES = ("coalesced", "emotional", "stream", "unbounded")
PEAKS: dict = {}                # peak device memory of phase 5b's serving


def artifact_live(pipe: EammPipeline, device: str = "cuda") -> EammPipeline:
    """The pipeline phase 7 exports: ``pipe``'s models in bfloat16 decode,
    yuv420, with the artifact's segments, chunks and length policy."""
    return EammPipeline(FULL_CONFIG, models=pipe.models, options=PipelineOptions(
        frame_chunk=32, time_bucket=32, compute_dtype=torch.bfloat16,
        transfer_format="yuv420", overlap_segments=ARTIFACT_SEGMENTS,
        segment_frames=ARTIFACT_FRAMES, stream_policy_frames=ARTIFACT_FRAMES,
        device=device))


def hold_programs(art, live: EammPipeline) -> dict:
    """Every program of ``art`` on inputs its host side makes from seeded
    requests, held bit for bit to the live pipeline's function of the same
    inputs -> program -> K1-K3 launches of the program's call."""
    import functools
    from eamm_tpu_torch.ops.mfcc import chunk_samples_len
    dev = art.device
    _, tp, src, win, pose = art._prepare_single(
        *clip_inputs(ARTIFACT_SECONDS, 700))
    emo = art.meta["emotional"]
    frames, u = art._emotion_inputs(emotion_clip(20, 7),
                                    emo["emo_frame_buckets"],
                                    emo["frames_dtype"], cut=tp)
    up, index = frames.shape[0], art._index(0, tp, u)
    _, srcs, wins, poses = art._prepare_batch(*zip(*(
        clip_inputs(ARTIFACT_SECONDS, 701 + i) for i in range(art.batch))))
    K = art.meta["unbounded"]["segment_frames"]
    gen = torch.Generator(device=dev).manual_seed(7)
    samples = 0.1 * torch.randn(1 + chunk_samples_len(K), device=dev,
                                generator=gen)
    pose_k = torch.randn(K, 6, device=dev, generator=gen)
    index_k = art._index(0, K, u)
    chunk = live._stream_kp_chunk_impl
    held, outputs = {}, {}

    def hold(name, fn, *args):
        torch.cuda.synchronize()
        reset_launch_counts()
        got = art._call(name, *args)
        torch.cuda.synchronize()
        held[name] = {k: v for k, v in launch_counts().items()
                      if k in RENDER_KERNELS}
        want = fn(*args)
        if len(got) != len(want) or not all(
                torch.equal(a, b) for a, b in zip(got, want)):
            raise AssertionError(f"artifact program {name}: not bitwise the "
                                 "live call")
        outputs[name] = got
        return got

    hold(f"{art.batch}x{tp}", live._batch_render_impl, srcs, wins, poses)
    hold(f"emo_{tp}x{up}", live._emo_render_from_windows_impl, src, win,
         pose, frames, index)
    kv, kj, ksv, ksj, feats = hold(f"kp_{tp}",
                                   live._kp_stage_from_windows_impl, src,
                                   win, pose)
    hold(f"kp_emo_{tp}x{up}", live._kp_stage_from_windows_impl, src, win,
         pose, frames, index)
    n = tp // art.meta["streaming"]["segments"]
    hold(f"seg_{tp}", live._render_segment_impl, src, feats, ksv, ksj,
         kv[:n], kj[:n])
    ksv, ksj, imgf, feats = hold("u_prelude", live._stream_prelude_impl, src)
    head = (ksv, ksj, imgf, samples, pose_k)
    for tag, emo_in in (("", ()), (f"emo{up}_", (frames, index_k))):
        kw = dict(emotional=bool(emo_in))
        kv, kj, *carry = hold(f"u_kp_{tag}first", functools.partial(
            chunk, first=True, **kw), *head, *emo_in)
        hold(f"u_kp_{tag}next", functools.partial(chunk, first=False, **kw),
             *head, *emo_in, *carry)
    hold("u_seg", live._render_segment_impl, src, feats, ksv, ksj, kv, kj)
    if set(held) != set(art._programs):
        raise AssertionError(f"programs held {sorted(held)} of "
                             f"{sorted(art._programs)}")
    return held


def artifact_requests(seed: int) -> dict:
    """Phase 7's requests: 4 neutral clips (a coalesced dispatch), one
    emotional with 20 raw frames, a stream, a long clip."""
    reqs = {f"coalesced.{i}": clip_inputs(ARTIFACT_SECONDS, seed + i)
            for i in range(4)}
    reqs["emotional"] = clip_inputs(ARTIFACT_SECONDS, seed + 4)
    reqs["stream"] = clip_inputs(ARTIFACT_SECONDS, seed + 5)
    reqs["unbounded"] = clip_inputs(ARTIFACT_LONG_SECONDS, seed + 6)
    return reqs


def artifact_phase(pipe: EammPipeline, device: str = "cuda") -> dict:
    """Phase 7: the frozen artifact.  Exported from ``artifact_live``;
    served by ``eamm-torch-serve --artifact`` (its load timed); every
    program held bitwise to its live call; each route driven on the
    server's ``ArtifactPipeline`` with launch counts; one round of
    concurrent HTTP requests, every call the worker made made again and
    held to its result bit for bit, each client's payload to its part of
    it; the coalesced call against the live pipeline's same call, bitwise
    and in turns -> route -> K1-K3 launches.  With cuDNN's deterministic
    algorithms (restored after)."""
    # cuDNN's default algorithms for some of ATNet's layers are not
    # deterministic: two live calls of the keypoint stage differ on the
    # card (chip_profile.py determinism), so programs and live calls are
    # held to each other with deterministic algorithms, both sides alike
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        return _artifact_phase(pipe, device)
    finally:
        torch.backends.cudnn.deterministic = deterministic


def _artifact_phase(pipe: EammPipeline, device: str) -> dict:
    from eamm_tpu_torch.cli import serve as serve_cli
    from eamm_tpu_torch.infer import export as ex
    from eamm_tpu_torch.serve_http import encode_request
    live = artifact_live(pipe, device)
    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "model.eammx")
        t0 = time.perf_counter()
        meta = ex.export_render_artifact(
            live, path, batch=4, frame_buckets=(ARTIFACT_FRAMES,),
            emotional=True, emo_frame_buckets=(ARTIFACT_EMO_FRAMES,),
            stream_segments=ARTIFACT_SEGMENTS,
            unbounded_frames=ARTIFACT_FRAMES)
        emit("artifact_export", wall_seconds=time.perf_counter() - t0,
             bytes=os.path.getsize(path),
             program_seconds=meta["export_seconds"],
             programs=len(meta["export_seconds"]))
        loads, load = [], ex.RenderArtifact.load.__func__

        def timed_load(cls, *args, **kwargs):
            t0 = time.perf_counter()
            art = load(cls, *args, **kwargs)
            loads.append(time.perf_counter() - t0)
            return art

        ex.RenderArtifact.load = classmethod(timed_load)
        stop, fronts = threading.Event(), []
        thread = threading.Thread(target=serve_cli.main, daemon=True, args=([
            "--artifact", path, "--host", "127.0.0.1", "--port", "0",
            "--max_delay_ms", "50", *(["--cpu"] if device == "cpu" else [])],),
            kwargs=dict(stop_event=stop, ready=fronts.append))
        thread.start()
        try:
            while not fronts:
                thread.join(1.0)
                if not thread.is_alive():
                    raise AssertionError("the artifact server did not start")
        finally:
            ex.RenderArtifact.load = classmethod(load)
        front = fronts[0]
        art_pipe = front.server.pipeline
        try:
            emit("artifact_load", seconds=loads, server=front.url,
                 max_batch=front.server.max_batch)
            programs = hold_programs(art_pipe.artifact, live)
            emit("artifact_programs", bitwise=sorted(programs),
                 launches=programs)
            reqs = artifact_requests(720)
            batch = [reqs[f"coalesced.{i}"] for i in range(4)]
            video = emotion_clip(20, 8)
            routes = {
                "coalesced": (lambda: art_pipe.render_batch_yuv420(
                    *zip(*batch)), ARTIFACT_SECONDS),
                "emotional": (lambda: art_pipe.render_yuv420(
                    *reqs["emotional"], video, add_emo=True),
                    ARTIFACT_SECONDS),
                "stream": (lambda: joined(art_pipe.render_stream(
                    *reqs["stream"], add_emo=False), {}), ARTIFACT_SECONDS),
                "unbounded": (lambda: art_pipe.render_yuv420(
                    *reqs["unbounded"], add_emo=False),
                    ARTIFACT_LONG_SECONDS)}
            by_route = {}
            for route, (fn, seconds) in routes.items():
                out, counts = drive(f"artifact {route}", RENDER_KERNELS, fn,
                                    seconds)
                by_route[route] = {k: counts[k] for k in RENDER_KERNELS}
            # the same batch call on the live pipeline: bitwise, in turns
            same_bits(routes["coalesced"][0](),
                      live.render_batch_yuv420(*zip(*batch)),
                      "artifact batch against live batch")
            walls = {"artifact": [], "live": []}
            for _ in range(3):
                for name in ("artifact", "live", "live", "artifact"):
                    fn = (routes["coalesced"][0] if name == "artifact" else
                          (lambda: live.render_batch_yuv420(*zip(*batch))))
                    t0 = time.perf_counter()
                    fn()
                    walls[name].append(1e3 * (time.perf_counter() - t0))
            serving = artifact_http_round(front, art_pipe, encode_request,
                                          video)
        finally:
            stop.set()
            thread.join(120)
        if thread.is_alive():
            raise AssertionError("the artifact server did not stop")
    emit("artifact_serving", **serving, batch_wall_ms={
        k: {"median": float(np.median(v)), "min": min(v), "max": max(v)}
        for k, v in walls.items()}, phase_seconds=time.perf_counter()
        - t_phase, serving_peak_phase_5b=PEAKS.get("serving"))
    return by_route


def artifact_http_round(front, art_pipe, encode_request, video) -> dict:
    """One round of concurrent HTTP clients on the artifact server: the
    4 neutral requests, the emotional one (raw frames), a /render_stream
    and the long request at once; every recorded call made again and held
    bit for bit, each client's payload to its part of it -> the round's
    report."""
    reqs = artifact_requests(740)
    rec = Recorder(art_pipe)
    bodies = {k: encode_request(*r, transformed=video if k == "emotional"
                                else None)
              for k, r in reqs.items()}
    jobs = {k: (lambda b=b: post(front.url + "/render", b))
            for k, b in bodies.items() if k != "stream"}
    jobs["stream"] = lambda: post_stream(front.url + "/render_stream",
                                         bodies["stream"])
    front.server.reset_stats()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    out, wall = concurrently(jobs)
    stats, _ = post(front.url + "/stats", None, "GET")
    peak = torch.cuda.max_memory_allocated()
    for call in rec.calls:
        again = rec.replay(call)
        if call["method"] == "render_stream":
            for (s0, p0), (_, p1) in zip(call["result"], again, strict=True):
                same_bits(p0, p1, f"artifact stream segment {s0}")
        else:
            same_bits(call["result"], again, f"artifact {call['method']}")
    latency = {}
    for key, req in reqs.items():
        call, row = served_by(rec.calls, req[1])
        T = num_windows_for_samples(len(req[1]))
        if key == "stream":
            segs, first, seconds = out[key]
            got = tuple(np.concatenate([s[k] for s in segs])
                        for k in ("y", "u", "v"))
            want = tuple(np.concatenate([p[i] for _, p in call["result"]])
                         for i in range(3))
        else:
            payload, seconds = out[key]
            got = _planes(payload)
            want = tuple((p[row] if row is not None else p)[:T]
                         for p in call["result"])
        same_bits(got, want, f"artifact {key}: client payload")
        latency.setdefault(key.split(".")[0], []).append(seconds)
    return {"requests": len(reqs), "wall_seconds": wall, "stats": stats,
            "calls": dict(collections.Counter(c["method"]
                                              for c in rec.calls)),
            "latency_seconds": {k: {"p50": float(np.median(v)),
                                    "max": max(v)}
                                for k, v in latency.items()},
            "peak_memory_allocated": peak}


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


# the warps' C entry points: ``launcher_call_ms`` times the wrapper's own
# launch without the operator's dispatch (what a call cost before the
# kernels were torch.library operators)
WARP_ENTRIES = {"warp_wide": "eamm_warp_wide",
                "warp_narrow": "eamm_warp_narrow",
                "warp_shared": "eamm_warp_shared"}


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
            entry, img = WARP_ENTRIES[name], (image if name != "warp_shared"
                                              else image[:1])
            eager = in_turns({"call_ms": (fns["ms"], 1),
                              "library_call_ms": (fns["library_ms"], 1),
                              "store_call_ms": (fns["store_ms"], 1),
                              "launcher_call_ms": (lambda: warp_cuda._launch(
                                  entry, img, grid, False), 1)})
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
    eager = in_turns({
        "kp_expectation_call_ms": (lambda: kpx.kp_expectation(*f32), 1),
        "kp_expectation_launcher_call_ms": (
            lambda: kpx._kp_expectation_cuda(*f32), 1),
        "fused_call_ms": (lambda: fused(*f32, True), 1),
        "fused_launcher_call_ms": (
            lambda: kpx._kp_expectation_fused_cuda(*f32, True), 1)})
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
            "library_ms": None, "bound": kp_bound(*f32[:2], False),
            "timing": {k: v for k, v in eager.items()
                       if k.startswith("kp_expectation")}},
        "kp_expectation_fused": {
            "ms": times["f32_heat"]["median"],
            "plain_ms": time_ms(lambda: kpx.kp_expectation_fused_plain(
                *f32, True)),
            "library_ms": None, "bound": kp_bound(*f32[:2], True),
            "timing": {**timing, **{k: v for k, v in eager.items()
                                    if k.startswith("fused")}},
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
    for result in cpu_vs_device("cuda").values():
        emit("cpu_vs_card", **result)
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
    serving = serving_phase(pipe)
    artifact_phase(pipe)
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
                     "launches_by_serving_route": {
                         route: counts[name]
                         for route, counts in serving.items()},
                     **{k: t[k] for k in ("timing", "plan") if k in t}})
    print(card_line(), flush=True)
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
