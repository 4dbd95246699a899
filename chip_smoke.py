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
   - entry points: the shared warp, the fused keypoint expectation and
     K6, which no model calls, once each at the shapes of phase 6.
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
   16, exported on the card at batch 4, one frame bucket of 32 (the 1.2 s
   requests' 29 frames), emotion bucket 16, 2 stream segments and
   unbounded chunks of 32 frames with the length policy at 32 (11
   programs; each program's export seconds, the file's bytes); served
   by ``eamm-torch-serve --artifact`` (``cli/serve.py`` ``main``), whose
   load of the file is timed; every program run on inputs the artifact's
   host side makes from seeded requests and held bitwise to the live
   pipeline's function on the same inputs, with K1-K3 launches per
   program; each route on the server's ``ArtifactPipeline`` (a batch of 4
   clips of 1.2 s, an emotional 1.2 s clip with 12 raw frames, a 1.2 s
   stream, a 2.5 s clip through the unbounded chunks) driven with launch
   counts (``artifact <route>`` requests: each of K1-K3 must launch); the
   batch call bitwise the live pipeline's same call, both timed in turns
   (wall ms, artifact, live, live, artifact; three rounds); then the same
   kinds of request at once from client threads over HTTP, every call the
   worker made made again and held to its result bit for bit, each
   client's payload to its part of it, with latencies and the peak
   device memory while serving beside phase 5b's.
8. training (after phase 7): the three backward kernels (K1b, K2b, K3b)
   against their plain versions (the autodiff of the plain forwards) at
   the fine-tune step's shapes (B 6, 4 supervised frames, 96 keypoint
   rows; the warps' grids from U(-1.2, 1.2)), in float32 and bfloat16,
   with both gradients and each alone, plus ragged outputs over two
   sources and align_corners=True: float32 within 1e-5 relative L2 and
   1e-4 of the largest |reference| in max |difference|, bfloat16 within
   1e-2 both; a finite-difference check per operator (``gradcheck`` of
   the plain version in float64 on the card, the kernel's float32
   gradient against central differences of its forward); one
   ``train_part1_fine_tune`` gradient (perceptual and GAN on, then the
   discriminator's) at TINY_CONFIG widths on the CPU in float64, on the
   CPU in float32 and on the card in float32 (losses within rtol 1e-4,
   BatchNorm statistics within 1e-5, each gradient leaf within 1e-3
   relative L2 or three times the largest error of the CPU's float32
   steps on 1, 2, 4 and 8 threads on it);
   then ``eamm-torch-run``'s ``main`` on a seeded synthetic LRW tree
   (packed frames) at FULL_CONFIG widths and the YAMLs' batches
   (``train_part1`` 8 x 16 frames; ``train_part1_fine_tune`` 6 x 16,
   perceptual and, by override, GAN on): TRAIN_STEPS steps each with the
   launch counts zeroed just before and read just after (K3 and K3b must
   launch in part1, all six in the fine-tune), each step's wall seconds,
   the peak device memory, every logged loss finite, the trained models
   changed and the frozen ones (weights and BatchNorm statistics) bit
   for bit as drawn, no cuDNN LSTM compaction warning, a checkpoint and
   one more step resumed from it with ``--checkpoint latest``; at each
   run's last checkpoint the visualizer's image (``read_png``: there,
   not blank) and its launches (K1-K3 must launch; taken out of the
   run's per-step counts); and one fine-tune step with
   ``--compute_dtype bfloat16``.  Phase 3b's K3b cases include part2's
   shapes: 256 images of 10 rows (the frozen detectors at the YAML's
   16 x 16 batch) and of 4 rows (EmotionMap's ``map_4`` head); K1b's and
   K2b's edges add near-identity grids with each gradient choice, grids
   wholly outside the image, ragged 29 x 45 sources, other groups and,
   for K2b, grad_out laid out as the training path passes it
   (``k1b_cases``, ``k2b_cases``).
9. part2 and the evaluation modes (after phase 8): one ``train_part2``
   gradient (``map_4``, ``smooth`` on) at TINY widths on the CPU in
   float64, on the CPU in float32 on 1, 2, 4 and 8 threads and on the
   card in float32, held as phase 8's step (each leaf's float32 error the
   largest of the four CPU runs), K3b's Jacobian-map gradient x1.1 as
   the control that must be refused; ``eamm-torch-run --mode
   train_part2`` at FULL_CONFIG and configs/train_part2.yaml's batch of
   16 x 16 frames on a seeded MEAD tree (4 identities, a neutral and an
   emotional clip each, packed), from FOMM and audio checkpoints written
   from seeded weights: ``linear_4`` with the host augmentation, with
   the device augmentation (then one step resumed with ``--checkpoint
   latest`` under ``torch.profiler``) and ``map_4`` with the device
   augmentation, PART2_STEPS steps
   each with launch counts zeroed just before and read just after (K3
   must launch, and K3b under ``map_4``), each step's wall seconds, peak
   memory, every loss finite, emo_detector changed and the frozen models
   (weights and BatchNorm statistics) bit for bit the checkpoints';
   ``--mode reconstruction`` (with ``--emo_checkpoint``) and ``--mode
   animate`` at FULL_CONFIG on a seeded Vox test split of 2 clips, on
   the card (K1-K3 must launch) and on the CPU: the card's metrics
   finite and within EVAL_TOL of the CPU's, the uint8 animations within
   the render's per-frame bounds.
10. the ``jaco_net: gan`` A2FD (after phase 9): ATNet decoding with the
   StyleGAN2 synthesis network (``models/stylegan2.py``), drawn from seed
   0, beside phase 5's other models at FULL_CONFIG (``with_gan_atnet``):
   the TINY gan pipeline rendered on the CPU and on the card as phase 4;
   neutral and emotional 4 s and 10 s
   ``render_uint8`` requests in bfloat16, each beside the same request on
   phase 5's cnn pipeline (wall, fps, peak memory; K1-K3 must launch),
   bf16 against f32 on the 4 s clips within phase 5's bounds, a 4 s
   float32 stream in chunks of 64 within one count of the whole clip;
   ATNet's share of the neutral 10 s keypoint stage, cnn and gan; the gan
   models as the reference's files (the audio file with the deconv
   decoder the reference also holds), preflighted and loaded back, one
   request through a ``RenderServer`` bitwise the call made again, and
   one gan artifact program (batch 1, bucket 32) bitwise its live call,
   both with cuDNN deterministic; ``eamm-torch-run --mode train_part1`` with
   ``jaco_net: gan`` at the YAML's 8 x 16 batch, 2 steps and one resumed
   (K3 and K3b must launch); the PNG decoders (which route
   ``decode_batch`` takes; a seeded batch of grey, RGB and RGBA files,
   rows under all five filters, through the standard library's zlib
   route, bitwise the images and, where the native library built, its
   decode); one TINY gan part1 gradient on the card against the CPU's
   float64 as phase 8's, K3b's Jacobian-map gradient x1.1 refused.
11. K6 and the mesh (after phase 10): K6 (``grid_sample_twolevel_b16``,
   the warp with its y pass rounded to bfloat16) against its plain version
   on the card, bfloat16 and float32 images at its own shape ([1,64,64,256]
   by [128,64,64,2], grid U(-1.05, 1.05)), at Bi = 2 and over ragged
   13 x 17 outputs: bitwise (each line counts the elements that differ,
   and must count none); then a process
   group of one rank over NCCL (``parallel/mesh.py``): the TINY
   ``train_part1`` gradient with BatchNorm over the global batch and the
   gradients all-reduced, held to the CPU's float64 step as phase 8's
   (K3b's Jacobian-map gradient x1.1 refused); a neutral 4 s clip through
   ``use_mesh([cuda:0])`` and with ``time_shard=True``, and a batch of 2
   through the mesh, each bitwise the unmeshed call (K1-K3 must launch);
   ``eamm-torch-run --mode train_part1`` under torchrun's variables at
   FULL_CONFIG and the YAML's batch, 2 steps (K3 and K3b must launch):
   step seconds, peak memory and losses beside phase 8's unsharded run.
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
   The plain versions are timed eager.  The backward kernels at the
   fine-tune step's shapes in float32 with the gradients the training
   path asks for (K1b both, K2b the grid's), beside
   ``aten.grid_sampler_2d_backward`` for the warps; their bound reads
   each input and writes each gradient once; K1b and K2b also at a
   near-identity grid, at the fine-tune step's own arguments (captured
   in phase 8) and with the image gradient alone, the grid's alone and
   both (``timing.attribution``; K2b's both also against
   ``bound_accumulator``, which counts its first design's float32
   accumulator as zeroed, read and written once per element), K2b with
   its launch ``plan``; K3b also at part2's ``map_4`` shape
   (256 images of 4 rows) with its plain version and bound
   (``timing.map_4``).  K6 at its own shape in the same turns as K1 on the
   same inputs (``timing.warp_wide_ms``), with F.grid_sample (which rounds
   once: not the same function), the store-only kernel and the eager
   calls.

Then the card's name and power limit, the ``{"kernels": [...]}`` line
(with the path whose launches each row counts, the launches on every
request by path, on every serving route, per training step of each
mode, per part2 step of each run, per evaluation mode and visualizer
call, on phase 10's gan paths and on phase 11's mesh paths; the
backward rows count the fine-tune run), and last
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import json
import os
import subprocess
import sys
import tempfile
import threading
import time
import warnings

import numpy as np
import torch
import torch.nn.functional as F

from eamm_tpu_torch import config as cfg
from eamm_tpu_torch import kernels
from eamm_tpu_torch.data.native import read_png
from eamm_tpu_torch.infer import EammPipeline, PipelineOptions
from eamm_tpu_torch.infer.pipeline import reset_parameters
from eamm_tpu_torch.models.audio import deconv_decoder
from eamm_tpu_torch.ops.colorspace import yuv420_to_rgb
from eamm_tpu_torch.ops.mfcc import (audio_to_mfcc_windows,
                                     num_windows_for_samples)
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
    "warp_wide_b16": (warp_cuda.grid_sample_twolevel_b16,
                      warp_cuda.grid_sample_twolevel_b16_plain,
                      "eamm_tpu_torch/csrc/warp.cu",
                      "benchmarks/bench_warp_variants.py:50"),
}
RENDER_KERNELS = ("warp_wide", "warp_narrow", "kp_expectation")
# the backward kernels of training; the TPU package differentiates XLA's
# warp (ops/warp.py grid_sample) and K3's custom_vjp (_bwd)
BACKWARD_KERNELS = {
    "warp_wide_backward": (warp_cuda.warp_wide_backward,
                           warp_cuda.grid_sample_backward_plain,
                           "eamm_tpu_torch/csrc/warp_backward.cu",
                           "eamm_tpu/ops/warp.py:47"),
    "warp_narrow_backward": (warp_cuda.warp_narrow_backward,
                             warp_cuda.grid_sample_backward_plain,
                             "eamm_tpu_torch/csrc/warp_backward.cu",
                             "eamm_tpu/ops/warp.py:47"),
    "kp_expectation_backward": (kpx.kp_expectation_backward,
                                kpx.kp_expectation_backward_plain,
                                "eamm_tpu_torch/csrc/kp_expectation.cu",
                                "eamm_tpu/ops/kp_expectation.py:122"),
}
KERNELS.update(BACKWARD_KERNELS)
TRAIN_KERNELS = RENDER_KERNELS + tuple(BACKWARD_KERNELS)
# each kernel's __global__ functions in csrc/, as a profile names them
# (K1b's gather launches its bins' three and the grid gradient's too)
KERNEL_SYMBOLS = {"warp_wide": ("warp_wide_kernel",),
                  "warp_narrow": ("warp_narrow_kernel",),
                  "kp_expectation": ("kp_expectation_kernel",),
                  "warp_wide_backward": ("warp_wide_backward_kernel",
                                         "bin_count_kernel",
                                         "bin_scan_kernel",
                                         "bin_place_kernel",
                                         "grid_grad_kernel"),
                  "warp_narrow_backward": ("warp_narrow_backward_kernel",),
                  "kp_expectation_backward": (
                      "kp_expectation_backward_kernel",)}
# the backward kernels' bounds against their plain versions: float32
# relative L2 error and max |difference| / max |reference| (atomics
# reorder the sums); bfloat16 both within 1e-2
GRAD_TOL = {torch.float32: (1e-5, 1e-4), torch.bfloat16: (1e-2, 1e-2)}


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
              grid_dtype: torch.dtype | None = None, outside: bool = False,
              image_hw: tuple[int, int] = (64, 64)):
    """A random [Bi,*image_hw,C] image and a [B,*hw,2] grid in U(-1.2,
    1.2), the grid in the image dtype unless ``grid_dtype`` is given; with
    ``outside``, |x| and |y| in [1.5, 3], so every corner lies outside."""
    image = torch.randn((Bi, *image_hw, C), generator=gen, device="cuda"
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


# ------------------------------------------------ phase 3b: the backward

def warp_grad_case(Bi: int, B: int, C: int, dtype: torch.dtype,
                   gen: torch.Generator, hw=(64, 64), need=(True, True),
                   align: bool = False, image_hw=(64, 64),
                   grid: str = "random"):
    """(grad_out, image, grid, align_corners, need_image, need_grid) for a
    warp backward: a random [Bi,*image_hw,C] image, a [B,*hw,2] grid and a
    random output gradient, in ``dtype``.  ``grid`` "random": U(-1.2,
    1.2), spread over the image and past its edges; "near_identity": each
    output pixel's own place in the image plus N(0, 0.03) (about a pixel
    at 64), as the training path's deformations are; "outside": every
    corner outside the image."""
    image, g = warp_case(Bi, B, hw, C, dtype, gen, outside=grid == "outside",
                         image_hw=image_hw)
    if grid == "near_identity":
        g = (identity_grid(hw, align) + 0.03 * torch.randn(
            (B, *hw, 2), generator=gen, device="cuda")).to(dtype)
    grad_out = torch.randn((B, *hw, C), generator=gen, device="cuda"
                           ).to(dtype)
    return (grad_out, image, g, align, *need)


def identity_grid(hw, align: bool) -> torch.Tensor:
    """The [*hw, 2] grid that samples each output pixel's own place."""
    axes = []
    for n in hw:
        i = torch.arange(n, device="cuda", dtype=torch.float32)
        axes.append(2 * i / max(n - 1, 1) - 1 if align else (2 * i + 1) / n - 1)
    y, x = torch.meshgrid(*axes, indexing="ij")
    return torch.stack([x, y], dim=-1)


def kp_grad_case(N: int, gen: torch.Generator, h: int = 58, w: int = 58,
                 K: int = 10, **kw):
    """(pred, jmap, temperature, g_value, g_jac) as the heads pass them
    (slices of one conv output; ``kw`` as ``kp_case`` takes them), with
    random output gradients."""
    pred, jmap, temperature = kp_case(N, gen, h, w, K=K, **kw)
    K = pred.shape[1]
    return (pred, jmap, temperature,
            torch.randn((N, K, 2), generator=gen, device="cuda"),
            torch.randn((N, K, 2, 2), generator=gen, device="cuda"))


def grad_cases(B: int = 6, frames: int = 4, N: int = 96) -> list:
    """(kernel, dtype, args) of the backward kernels at the fine-tune
    step's shapes (B identities, ``frames`` supervised frames, N keypoint
    rows), both gradients and the ones the training path asks for, plus a
    ragged output over two sources and align_corners=True, then K1b's,
    K2b's and K3b's edges (``k1b_cases``, ``k2b_cases``, ``k3b_cases``)."""
    gen = torch.Generator(device="cuda").manual_seed(3)
    n = B * frames
    cases = []
    for dtype in (torch.float32, torch.bfloat16):
        for need in ((True, True), (False, True), (True, False)):
            cases.append(("warp_wide_backward", dtype,
                          warp_grad_case(n, n, 256, dtype, gen, need=need)))
            cases.append(("warp_narrow_backward", dtype,
                          warp_grad_case(n, 11 * n, 3, dtype, gen,
                                         need=need)))
        cases.append(("warp_wide_backward", dtype,
                      warp_grad_case(2, 4, 256, dtype, gen, hw=(13, 17))))
        cases.append(("warp_narrow_backward", dtype,
                      warp_grad_case(2, 6, 3, dtype, gen, hw=(13, 17),
                                     align=True)))
    # part2's shapes too: the frozen detectors' 256 images of 10 rows and
    # EmotionMap's map_4 head, 4 rows an image (B 16 x T 16)
    for rows, hw, K in ((N, (58, 58), 10), (B, (58, 58), 10),
                        (3, (13, 17), 10), (PART2_ROWS, (58, 58), 10),
                        (PART2_ROWS, (58, 58), 4)):
        cases.append(("kp_expectation_backward", torch.float32,
                      kp_grad_case(rows, gen, *hw, K=K)))
    return cases + k1b_cases(gen, n) + k2b_cases(gen, n) + k3b_cases(gen)


def k1b_cases(gen: torch.Generator, n: int) -> list:
    """K1b's gather at its edges, both dtypes: the near-identity grid of
    the training path (its pixels' corners in their own tile and the
    neighbours') with each of the three gradient choices; grids wholly
    outside the image; sources that are no multiple of the 8x8 tile
    (29 x 45, a 13 x 17 output, align_corners); grids of one source in
    many blocks (group 4 and 3)."""
    cases = []
    for dtype in (torch.float32, torch.bfloat16):
        for need in ((True, True), (False, True), (True, False)):
            cases.append(("warp_wide_backward", dtype,
                          warp_grad_case(n, n, 256, dtype, gen, need=need,
                                         grid="near_identity")))
        cases.append(("warp_wide_backward", dtype,
                      warp_grad_case(2, 4, 256, dtype, gen, grid="outside")))
        cases.append(("warp_wide_backward", dtype,
                      warp_grad_case(2, 6, 256, dtype, gen, hw=(13, 17),
                                     align=True, image_hw=(29, 45),
                                     grid="near_identity")))
        cases.append(("warp_wide_backward", dtype,
                      warp_grad_case(2, 6, 256, dtype, gen, hw=(13, 17),
                                     image_hw=(29, 45))))
        cases.append(("warp_wide_backward", dtype,
                      warp_grad_case(n // 4, n, 256, dtype, gen,
                                     grid="near_identity")))
    return cases


def k2b_cases(gen: torch.Generator, n: int) -> list:
    """K2b at its edges, both dtypes: the near-identity grid of the
    training path with each of the three gradient choices; grids wholly
    outside the image; a ragged 29 x 45 source under 13 x 17 grids, whose
    sources start part-way into a run of pixels (group 11, with
    align_corners, and group 3); group 1; grad_out laid out as the
    training path passes it (``planar``, read in place), at 64 x 64 and
    13 x 17; C = 5 (the kernel for any C up to 8)."""
    cases = []
    for dtype in (torch.float32, torch.bfloat16):
        for need in ((True, True), (False, True), (True, False)):
            cases.append(("warp_narrow_backward", dtype,
                          warp_grad_case(n, 11 * n, 3, dtype, gen, need=need,
                                         grid="near_identity")))
        cases.append(("warp_narrow_backward", dtype,
                      warp_grad_case(2, 22, 3, dtype, gen, grid="outside")))
        cases.append(("warp_narrow_backward", dtype,
                      warp_grad_case(3, 33, 3, dtype, gen, hw=(13, 17),
                                     align=True, image_hw=(29, 45),
                                     grid="near_identity")))
        cases.append(("warp_narrow_backward", dtype,
                      warp_grad_case(3, 9, 3, dtype, gen, hw=(13, 17),
                                     image_hw=(29, 45))))
        cases.append(("warp_narrow_backward", dtype,
                      warp_grad_case(4, 4, 3, dtype, gen, image_hw=(29, 45),
                                     grid="near_identity")))
        for hw in ((64, 64), (13, 17)):
            args = warp_grad_case(n, 11 * n, 3, dtype, gen, hw=hw,
                                  grid="near_identity")
            cases.append(("warp_narrow_backward", dtype,
                          (planar(args[0]), *args[1:])))
        cases.append(("warp_narrow_backward", dtype,
                      warp_grad_case(2, 6, 5, dtype, gen, hw=(13, 17))))
    return cases


def planar(grad_out: torch.Tensor) -> torch.Tensor:
    """``grad_out`` [N,h,w,C] as dense motion's gradient reaches K2b: a
    plane a channel behind a heatmap's plane, C + 1 planes an image."""
    N, h, w, C = grad_out.shape
    planes = torch.zeros((N, C + 1, h, w), dtype=grad_out.dtype,
                         device=grad_out.device)
    planes[:, 1:] = grad_out.permute(0, 3, 1, 2)
    return planes[:, 1:].permute(0, 2, 3, 1)


def k3b_cases(gen: torch.Generator) -> list:
    """K3b's plans at their edges: rows of 57 x 57 (no multiple of 4: a
    row's four grad_jmap planes start at four phases against 16 bytes, so
    every row goes one pixel at a time), the planes 4 bytes off 16 (the
    same), a 128 x 128 row (past the register plan: the shared-memory
    path), K = 4 and 10, temperature 1."""
    return [("kp_expectation_backward", torch.float32, args) for args in (
        kp_grad_case(16, gen, 57, 57),
        kp_grad_case(16, gen, 57, 57, K=4),
        kp_grad_case(16, gen, offset=1),
        kp_grad_case(2, gen, 128, 128),
        kp_grad_case(2, gen, 128, 128, K=4, offset=1),
        kp_grad_case(16, gen, temperature=1.0))]


def grad_errors(got, want) -> tuple[float, float]:
    """(relative L2 error, max |difference| / max |reference|)."""
    g, w = got.double(), want.double()
    scale = w.abs().max().item() or 1.0
    norm = w.norm().item() or 1.0
    return ((g - w).norm().item() / norm,
            (g - w).abs().max().item() / scale)


def grad_parity(cases: list) -> dict:
    """Each backward kernel against its plain version (autodiff of the
    plain forward) on the same inputs, held to GRAD_TOL; returns the
    largest max |difference| per kernel."""
    worst = {name: 0.0 for name in BACKWARD_KERNELS}
    for name, dtype, args in cases:
        wrapper, plain = BACKWARD_KERNELS[name][:2]
        got, want = wrapper(*args), plain(*args)
        torch.cuda.synchronize()
        rel_tol, max_tol = GRAD_TOL[dtype]
        errs = []
        for g, w in zip(got, want):
            if w.numel() == 0:
                if g.numel() != 0:
                    raise AssertionError(f"{name}: a gradient not asked for")
                continue
            if g.shape != w.shape or g.dtype != w.dtype:
                raise AssertionError(f"{name}: {g.shape} {g.dtype} against "
                                     f"{w.shape} {w.dtype}")
            rel, mx = grad_errors(g, w)
            errs.append({"rel_l2": rel, "max_rel": mx})
            if not (rel <= rel_tol and mx <= max_tol):
                raise AssertionError(f"{name} {dtype}: relative L2 {rel}, "
                                     f"max {mx} (bounds {rel_tol}, "
                                     f"{max_tol})")
            worst[name] = max(worst[name],
                              (g.float() - w.float()).abs().max().item())
        tensors = [a for a in args if torch.is_tensor(a)]
        emit("grad_parity", kernel=name, dtype=str(dtype),
             shapes=[list(a.shape) for a in tensors],
             flags=[a for a in args if isinstance(a, bool)], errors=errs,
             bounds=GRAD_TOL[dtype])
    return worst


def finite_differences() -> dict:
    """One finite-difference check per backward op at a small shape:
    ``torch.autograd.gradcheck`` of the plain version in float64 on the
    card, and the kernel's gradient in float32 against central
    differences of the kernel's own forward (step 1e-3 in float32, a
    bound of 2e-2 relative L2: the forward rounds to float32, and a probe
    may straddle a pixel edge, where the warp has a kink)."""
    gen = torch.Generator(device="cuda").manual_seed(4)
    out = {}
    for name, fwd in (("warp_wide_backward", warp_cuda.grid_sample_wide),
                      ("warp_narrow_backward", warp_cuda.grid_sample_narrow)):
        C = 8 if name == "warp_wide_backward" else 3
        image = torch.randn((2, 6, 7, C), generator=gen, device="cuda",
                            dtype=torch.float64)
        grid = torch.rand((4, 5, 3, 2), generator=gen, device="cuda",
                          dtype=torch.float64) * 2.2 - 1.1
        ok = torch.autograd.gradcheck(
            lambda i, g: warp_cuda.grid_sample_plain(i, g),
            (image.requires_grad_(), grid.requires_grad_()))
        out[name] = {"plain_float64_gradcheck": ok,
                     "kernel_float32": kernel_fd(
                         fwd, (image.detach().float(), grid.detach().float()))}
    pred = torch.randn((2, 3, 6, 5), generator=gen, device="cuda",
                       dtype=torch.float64)
    jmap = torch.randn((2, 3, 4, 6, 5), generator=gen, device="cuda",
                       dtype=torch.float64)
    ok = torch.autograd.gradcheck(
        lambda p, j: kpx.kp_expectation_plain(p, j, 0.1),
        (pred.requires_grad_(), jmap.requires_grad_()))
    out["kp_expectation_backward"] = {
        "plain_float64_gradcheck": ok,
        "kernel_float32": kernel_fd(
            lambda p, j: torch.cat([t.flatten(1) for t in
                                    kpx.kp_expectation(p, j, 1.0)], 1),
            (pred.detach().float(), jmap.detach().float()))}
    for name, r in out.items():
        if not r["plain_float64_gradcheck"] or \
                r["kernel_float32"]["rel_l2"] > 2e-2:
            raise AssertionError(f"{name}: finite differences {r}")
    return out


def kernel_fd(fwd, inputs: tuple, step: float = 1e-3,
              probes: int = 24) -> dict:
    """The kernel's gradient of sum(v * fwd(inputs)) for a random v against
    central differences of that sum along ``probes`` random coordinates
    of each input, in float32 on the card."""
    gen = torch.Generator(device="cuda").manual_seed(5)
    args = [t.clone().requires_grad_() for t in inputs]
    out = fwd(*args)
    v = torch.randn(out.shape, generator=gen, device="cuda")
    grads = torch.autograd.grad((out.float() * v).sum(), args)
    got, want = [], []
    with torch.no_grad():
        for i, t in enumerate(inputs):
            for j in torch.randint(t.numel(), (probes,), generator=gen,
                                   device="cuda").tolist():
                plus, minus = t.clone(), t.clone()
                plus.view(-1)[j] += step
                minus.view(-1)[j] -= step
                f, m = list(inputs), list(inputs)
                f[i], m[i] = plus, minus
                d = ((fwd(*f).float() * v).sum()
                     - (fwd(*m).float() * v).sum()) / (2 * step)
                got.append(grads[i].reshape(-1)[j].item())
                want.append(d.item())
    got, want = torch.tensor(got), torch.tensor(want)
    return {"probes": len(got),
            "rel_l2": ((got - want).norm() / want.norm()).item()}


# ---------------------------------------------------------------- phase 4

def cpu_vs_device(device: str = "cuda", seed: int = 0,
                  tune=lambda pipe: pipe) -> dict:
    """The same seeded pipeline at EMOTION_TINY_CONFIG (TINY_CONFIG's four
    render models, drawn before the emotion model; ``tune(pipeline)`` may
    change it, as ``with_gan_atnet`` does) built on the CPU and on
    ``device``; the same 1 s clip rendered on both, neutral and emotional
    with 5 emotion frames -> {'neutral', 'emotional'} results; raises
    unless each render's per-frame mean |difference| has max < 1e-2 and
    mean < 3e-3."""
    opts = dict(frame_chunk=8, time_bucket=8)
    cpu = tune(EammPipeline.from_random(
        EMOTION_TINY_CONFIG, seed, PipelineOptions(device="cpu", **opts)))
    dev = tune(EammPipeline.from_random(
        EMOTION_TINY_CONFIG, seed, PipelineOptions(device=device, **opts)))
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
    return EammPipeline(pipe.config, models=pipe.models,
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
    """The shared warp, the fused keypoint expectation and K6 through
    their own entry points (no model calls them)."""
    gen = torch.Generator(device="cuda").manual_seed(2)
    image, grid = warp_case(1, 32, (64, 64), 256, torch.float32, gen)
    pred, jmap, temp = kp_case(256, gen)
    k6_image, k6_grid = k6_case(1, K6_B, (64, 64), torch.bfloat16, gen)
    _, launches = drive("entry points", ("warp_shared", "kp_expectation_fused",
                                         "warp_wide_b16"),
                        lambda: (warp_cuda.grid_sample_shared(image[0], grid),
                                 kpx.kp_expectation_fused(pred, jmap, temp,
                                                          True),
                                 warp_cuda.grid_sample_twolevel_b16(
                                     k6_image, k6_grid)))
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
    epoch number; the emotion file with Emotion_k's ``final_4`` stack; a
    gan ATNet's with the deconv decoder the reference also holds ->
    {'fomm', 'audio', 'emo'} paths."""
    sd = {k: {n: t.cpu() for n, t in m.state_dict().items()}
          for k, m in models.items()}
    if models["audio_feature"].jaco_net == "gan":
        # the reference's AT_net builds the deconv decoder whatever
        # jaco_net says, so its gan files hold decon.* too (seeded here)
        decon = deconv_decoder()
        reset_parameters(decon, torch.Generator().manual_seed(1))
        sd["audio_feature"] = {**{f"decon.{k}": v for k, v
                                  in decon.state_dict().items()},
                               **sd["audio_feature"]}
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
                    options: PipelineOptions) -> tuple[dict, EammPipeline]:
    """Save ``pipe``'s models as the reference's checkpoints, check each
    with the preflight (ok, nothing fatal), load them back through
    ``from_torch_checkpoints`` at ``pipe``'s config under ``options`` and
    hold every state_dict to the original's bit for bit -> (the paths,
    the loaded pipeline)."""
    from eamm_tpu_torch.compat.preflight import check_state_dict
    paths = save_checkpoints(pipe.models, directory)
    reports = {name: check_state_dict(path) for name, path in paths.items()}
    loaded = EammPipeline.from_torch_checkpoints(
        pipe.config, paths["fomm"], paths["audio"], paths["emo"], options)
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
    return paths, loaded


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
        paths, _ = checkpoint_path(pipe, d, PipelineOptions(device=device))
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

# the artifact's frame bucket (the 1.2 s requests' 29 frames ride it), its
# unbounded chunk and length policy, its segments, its emotion bucket and
# the emotional requests' raw frames; the live pipeline decodes chunks of
# ARTIFACT_CHUNK frames.  Exporting and loading unroll the one-euro loops
# over the bucket's frames: 64 frames and 32 emotion frames took 222 s to
# export and 98 s to load on an H100's host, so the bucket is 32 frames,
# half of a realistic request's 64
ARTIFACT_FRAMES = 32
ARTIFACT_CHUNK = 16
ARTIFACT_SEGMENTS = 2
ARTIFACT_EMO_FRAMES = 16
ARTIFACT_EMOTION_CLIP = 12
ARTIFACT_SECONDS = 1.2
ARTIFACT_LONG_SECONDS = 2.5     # 61 frames: two unbounded chunks
ARTIFACT_ROUTES = ("coalesced", "emotional", "stream", "unbounded")
PEAKS: dict = {}                # peak device memory of phase 5b's serving


def artifact_live(pipe: EammPipeline, device: str = "cuda") -> EammPipeline:
    """The pipeline phase 7 exports: ``pipe``'s models in bfloat16 decode,
    yuv420, with the artifact's segments, chunks and length policy."""
    return EammPipeline(FULL_CONFIG, models=pipe.models, options=PipelineOptions(
        frame_chunk=ARTIFACT_CHUNK, time_bucket=ARTIFACT_CHUNK,
        compute_dtype=torch.bfloat16,
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
    frames, u = art._emotion_inputs(emotion_clip(ARTIFACT_EMOTION_CLIP, 7),
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
    emotional with ARTIFACT_EMOTION_CLIP raw frames, a stream, a long
    clip."""
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
            lstm = [t for k, t in art_pipe.artifact.weights.items()
                    if ".lstm." in k]
            storages = {t.untyped_storage().data_ptr() for t in lstm}
            emit("artifact_load", seconds=loads, server=front.url,
                 max_batch=front.server.max_batch,
                 lstm_tensors=len(lstm), lstm_storages=len(storages))
            if device == "cuda" and len(storages) != 1:
                raise AssertionError("the loaded LSTM weights are not one "
                                     f"flat buffer: {len(storages)} storages")
            programs = hold_programs(art_pipe.artifact, live)
            emit("artifact_programs", bitwise=sorted(programs),
                 launches=programs)
            reqs = artifact_requests(720)
            batch = [reqs[f"coalesced.{i}"] for i in range(4)]
            video = emotion_clip(ARTIFACT_EMOTION_CLIP, 8)
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
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                for _ in range(3):
                    for name in ("artifact", "live", "live", "artifact"):
                        fn = (routes["coalesced"][0] if name == "artifact"
                              else (lambda: live.render_batch_yuv420(
                                  *zip(*batch))))
                        t0 = time.perf_counter()
                        fn()
                        walls[name].append(1e3 * (time.perf_counter() - t0))
            compacted = [str(w.message) for w in caught
                         if "contiguous chunk" in str(w.message)]
            if compacted:
                raise AssertionError("cuDNN compacted LSTM weights during "
                                     f"the batch calls: {compacted[:1]}")
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


# ------------------------------------------------------- phase 8: training

# configs/train_part1.yaml and configs/train_part1_fine_tune.yaml's
# train_params (the card's machine may lack PyYAML; tests hold these to
# the files); the fine-tune's GAN weights are this phase's override
TRAIN_PARAMS = {
    "train_part1": {
        "jaco_net": "cnn", "ldmark": "fake", "generator": "not",
        "num_epochs": 300, "num_repeats": 1, "epoch_milestones": [60, 90],
        "lr_generator": 2.0e-4, "lr_discriminator": 2.0e-4,
        "lr_kp_detector": 2.0e-4, "lr_audio_feature": 2.0e-4,
        "batch_size": 8, "scales": [1, 0.5, 0.25, 0.125],
        "checkpoint_freq": 1, "log_every": 10, "steps_per_dispatch": 1,
        "transform_params": {"sigma_affine": 0.05, "sigma_tps": 0.005,
                             "points_tps": 5},
        "loss_weights": {"generator_gan": 0, "discriminator_gan": 0,
                         "feature_matching": [10, 10, 10, 10],
                         "perceptual": [10, 10, 10, 10, 10],
                         "equivariance_value": 0,
                         "equivariance_jacobian": 0, "audio": 10}},
    "train_part1_fine_tune": {
        "jaco_net": "cnn", "ldmark": "fake", "generator": "audio",
        "num_epochs": 300, "num_repeats": 1, "epoch_milestones": [60, 90],
        "lr_generator": 2.0e-4, "lr_discriminator": 2.0e-4,
        "lr_kp_detector": 2.0e-4, "lr_audio_feature": 2.0e-4,
        "batch_size": 6, "scales": [1, 0.5, 0.25, 0.125],
        "checkpoint_freq": 1, "log_every": 10, "steps_per_dispatch": 1,
        "transform_params": {"sigma_affine": 0.05, "sigma_tps": 0.005,
                             "points_tps": 5},
        "loss_weights": {"generator_gan": 0, "discriminator_gan": 0,
                         "feature_matching": [10, 10, 10, 10],
                         "perceptual": [0.1, 0.1, 0.1, 0.1, 0.1],
                         "equivariance_value": 0,
                         "equivariance_jacobian": 0, "audio": 10}},
}
GAN_ON = {"generator_gan": 1, "discriminator_gan": 1}
TRAIN_STEPS = 4                 # per mode at full width; the first warms up
TRAIN_CLIPS = 4                 # synthetic LRW clips of 30 frames
MODE_KERNELS = {"train_part1": ("kp_expectation", "kp_expectation_backward"),
                "train_part1_fine_tune": TRAIN_KERNELS}
# the CPU-against-card step: losses rtol, gradient relative L2 per leaf,
# BatchNorm statistics (the CPU tests' bounds)
STEP_TOL = {"loss_rtol": 1e-4, "grad_rel_l2": 1e-3, "stats": 1e-5}
# torch's intra-op threads of the CPU float32 steps a CPU-against-card
# gradient takes its float32 floor from: four summation orders
FLOAT32_THREADS = (1, 2, 4, 8)


def write_lrw_tree(root: str, clips: int = TRAIN_CLIPS, frames: int = 30,
                   seed: int = 11) -> None:
    """A seeded LRW-layout tree: per clip a ``frames.eammpack`` of 256x256
    frames (no PNG codec needed), MFCC windows and a pose track."""
    from eamm_tpu_torch.data.packed import write_pack
    rng = np.random.RandomState(seed)
    for c in range(clips):
        clip = f"W/c{c}"
        img = os.path.join(root, "Image", "train_fo", clip)
        mfcc = os.path.join(root, "MFCC", "train", clip)
        pose = os.path.join(root, "pose", "train_fo", "W")
        for d in (img, mfcc, pose):
            os.makedirs(d, exist_ok=True)
        write_pack(os.path.join(img, "frames.eammpack"), list(range(frames)),
                   rng.randint(0, 256, (frames, 256, 256, 3), np.uint8))
        for i in range(frames):
            np.save(os.path.join(mfcc, f"{i}.npy"), rng.randn(28, 13))
        np.save(os.path.join(pose, f"c{c}.npy"), rng.randn(frames, 7))


def train_config(mode: str, root: str, model_config: dict, **overrides):
    """The mode's config over ``model_config``'s widths and the tree."""
    tp = json.loads(json.dumps(TRAIN_PARAMS[mode]))
    tp.update(overrides)
    if mode == "train_part1_fine_tune":
        tp["loss_weights"].update(GAN_ON)
    return {**json.loads(json.dumps(model_config)), "train_params": tp,
            "dataset_params": {"name": "LRW", "root_dir": root,
                               "frame_shape": [256, 256, 3],
                               "augmentation_params": {}}}


def model_tensors(models: dict) -> dict:
    return {name: {k: v.detach().clone() for k, v in m.state_dict().items()}
            for name, m in models.items()}


@contextlib.contextmanager
def timed_steps(maker: str):
    """While in use, the steps that ``train.steps.<maker>`` makes record
    their wall seconds (host clock, ended by a synchronize) in ``walls``;
    once ``profiled['on']`` is set they run under ``profiled_step``
    instead.  Yields (walls, profiled)."""
    from eamm_tpu_torch.train import steps as S
    inner = getattr(S, maker)
    walls: list = []
    profiled: dict = {}

    def timed(tp):
        step = inner(tp)

        def run(state, batch):
            if "on" in profiled:
                return profiled_step(step, state, batch, profiled)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = step(state, batch)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
            return out
        return run

    setattr(S, maker, timed)
    try:
        yield walls, profiled
    finally:
        setattr(S, maker, inner)


@contextlib.contextmanager
def capture_backward(captured: dict):
    """While in use, the first K1b and the first K2b launch's arguments
    (grad_out, image, grid, align_corners, need_image, need_grid), cloned
    into ``captured`` by kernel name: ``warp_cuda._launch_backward`` is
    wrapped, as ``capture_warps`` wraps the forward warps."""
    inner = warp_cuda._launch_backward
    names = {"eamm_warp_wide_backward": "warp_wide_backward",
             "eamm_warp_narrow_backward": "warp_narrow_backward"}

    def spy(entry, grad_out, image, grid, *rest):
        if names[entry] not in captured:
            captured[names[entry]] = (grad_out.clone(), image.clone(),
                                      grid.clone(), *rest)
        return inner(entry, grad_out, image, grid, *rest)

    warp_cuda._launch_backward = spy
    try:
        yield
    finally:
        warp_cuda._launch_backward = inner


def train_entry_point(mode: str, root: str, work: str,
                      device: str = "cuda", steps: int = TRAIN_STEPS,
                      jaco_net: str = "cnn",
                      backward_args: dict | None = None) -> dict:
    """``eamm-torch-run``'s ``main`` at FULL_CONFIG widths (ATNet's
    ``jaco_net`` decoder) and the YAML's batch: ``steps`` steps with every
    launch count zeroed just before and read just after, each step's wall
    seconds, peak memory; every loss finite, the trained models changed,
    the frozen ones (weights and BatchNorm statistics) bit for bit as
    drawn; a checkpoint, then one more step resumed from it with
    ``--checkpoint latest``.  With ``backward_args``, the run's first K1b
    and K2b launches' arguments go into it (``capture_backward``)."""
    from eamm_tpu_torch.cli.run import main as run_main
    from eamm_tpu_torch.train.logging import read_scalars
    from eamm_tpu_torch.train.loop import build_models
    cfg = train_config(mode, root, FULL_CONFIG, num_repeats=8,
                       log_every=1, jaco_net=jaco_net)
    label = mode if jaco_net == "cnn" else f"{mode} {jaco_net}"
    path = os.path.join(work, f"{mode}_{jaco_net}.json")
    with open(path, "w") as f:
        json.dump(cfg, f)
    log = os.path.join(work, f"log_{mode}_{jaco_net}")
    argv = ["--config", path, "--mode", mode, "--log_dir", log,
            *(["--cpu"] if device == "cpu" else [])]
    images = CountedVisualizer()
    capture = (capture_backward(backward_args) if backward_args is not None
               else contextlib.nullcontext())
    try:
        with timed_steps("make_part1_step") as (walls, profiled), capture:
            torch.cuda.reset_peak_memory_stats()
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                state, counts = drive(label, MODE_KERNELS[mode],
                                      lambda: run_main(argv + [
                                          "--max_steps", str(steps)]),
                                      info={"steps": steps})
            peak = torch.cuda.max_memory_allocated()
            drawn = model_tensors(build_models(
                cfg, mode, mode == "train_part1_fine_tune", 0, device))
            after = model_tensors(state.models)
            profiled["on"] = True
            resumed = run_main(argv + ["--max_steps", "1", "--checkpoint",
                                       "latest"])
    finally:
        images.close()
    # the visualizer ran at the run's last checkpoint, inside the counts
    viz = images.calls[0]
    counts = {k: v - viz["launches"][k] for k, v in counts.items()}
    compacted = [str(w.message) for w in caught
                 if "contiguous chunk" in str(w.message)]
    if compacted:
        raise AssertionError(f"{mode}: cuDNN compacted LSTM weights: "
                             f"{compacted[:1]}")
    changed = {name: any(not torch.equal(v, after[name][k])
                         for k, v in tensors.items())
               for name, tensors in drawn.items()}
    for name, moved in changed.items():
        if moved != (name in state.trainable or name == "discriminator"):
            raise AssertionError(f"{mode}: {name} changed={moved}")
    (run,) = os.listdir(log)
    scalars = read_scalars(os.path.join(log, run, "scalars.jsonl"))
    losses = {tag: [float(v) for v in vals]
              for tag, (_, vals) in scalars.items()}
    if not all(np.isfinite(v).all() for v in losses.values()):
        raise AssertionError(f"{mode}: a loss is not finite: {losses}")
    if state.step != steps or resumed.step != steps + 1:
        raise AssertionError(f"{label}: steps {state.step}, resumed "
                             f"{resumed.step}")
    result = {"mode": mode, "jaco_net": jaco_net,
              "batch": cfg["train_params"]["batch_size"],
              "frames": 16, "steps": steps,
              "step_seconds": walls[:steps],
              "step_seconds_median": float(np.median(walls[1:steps])),
              "resumed_step_profile": profiled.get("summary"),
              "peak_memory_allocated": peak, "launches": counts,
              "launches_per_step": {k: v / steps
                                    for k, v in counts.items()},
              "losses": losses, "changed": changed,
              "resumed_at": resumed.step, "visualizer": images.calls,
              "card": card_line()}
    emit("train_entry_point", **result)
    return result


class CountedVisualizer:
    """Wrap the training loop's ``visualize_checkpoint`` while in use:
    each call's launches (the counts' difference across it, the outer
    run's counts left running) and its image, which must exist and not be
    blank (a standard deviation of more than 10 counts); K1-K3 must
    launch."""

    def __init__(self):
        from eamm_tpu_torch.train import loop
        self.loop, self.inner = loop, loop.visualize_checkpoint
        self.calls: list = []
        loop.visualize_checkpoint = self

    def __call__(self, *args, **kwargs):
        torch.cuda.synchronize()
        before = launch_counts()
        t0 = time.perf_counter()
        path = self.inner(*args, **kwargs)
        torch.cuda.synchronize()
        launches = {k: v - before[k] for k, v in launch_counts().items()}
        image = read_png(path)
        call = {"path": os.path.basename(path), "shape": list(image.shape),
                "std": float(image.std()), "launches": launches,
                "wall_seconds": time.perf_counter() - t0}
        self.calls.append(call)
        return path

    def close(self):
        self.loop.visualize_checkpoint = self.inner
        for call in self.calls:
            missing = [k for k in RENDER_KERNELS if call["launches"][k] <= 0]
            if call["std"] <= 10 or missing:
                raise AssertionError(f"visualizer: {call}; not launched: "
                                     f"{missing}")
        if not self.calls:
            raise AssertionError("visualizer: no image written")


# planted faults: one backward's output scaled on the card, each a wrong
# backward, and whether the CPU-against-card step must refuse it (a 10%
# mis-scale must be refused; the 1% one is read for the comparison's
# reach, which the float32 floor of its bounds limits)
FAULTS = {"K1b_grad_grid_x1.01": ("eamm_warp_wide_backward", 1.01, False),
          "K1b_grad_grid_x1.1": ("eamm_warp_wide_backward", 1.1, True),
          "K2b_grad_grid_x1.1": ("eamm_warp_narrow_backward", 1.1, True),
          "K3b_grad_jmap_x1.1": ("kp_expectation_backward", 1.1, True)}


# each must-refuse fault's reading (its worst leaf's error over the leaf's
# bound) on the card before the backward kernels' redesign, by comparison
# line, as PERF.md records them: printed beside each run's own
EARLIER_FAULT_OVER = {
    "train_cpu_vs_card": {"K1b_grad_grid_x1.1": 3.08,
                          "K2b_grad_grid_x1.1": 1.61,
                          "K3b_grad_jmap_x1.1": 1.40},
    "gan_train_cpu_vs_card": {"K3b_grad_jmap_x1.1": 124.9}}


@contextlib.contextmanager
def planted_fault(entry: str, scale: float):
    """Scale K1b's or K2b's grid gradient (``entry`` their C entry point)
    or K3b's Jacobian-map gradient by ``scale`` while the block runs."""
    if entry == "kp_expectation_backward":
        module, name = kpx, "kp_expectation_backward_op"

        def faulty(*args):
            grad_pred, grad_jmap = inner(*args)
            return grad_pred, grad_jmap * scale
    else:
        module, name = warp_cuda, "_launch_backward"

        def faulty(which, *args):
            grad_image, grad_grid = inner(which, *args)
            return grad_image, (grad_grid * scale if which == entry
                                else grad_grid)
    inner = getattr(module, name)
    setattr(module, name, faulty)
    try:
        yield
    finally:
        setattr(module, name, inner)


def step_gradients(cfg: dict, batch: dict, seed: int, where: str,
                   dtype: torch.dtype,
                   mode: str = "train_part1_fine_tune",
                   synced: bool = False, keep: dict | None = None) -> dict:
    """One ``mode`` gradient (and, in the fine-tune, its discriminator's)
    on ``where`` in ``dtype``: the metrics, each trained leaf's gradient
    and the trained models' BatchNorm statistics, in float64 on the
    CPU.  ``synced``: a distributed run's step (its process group joined
    by the caller): BatchNorm over the global batch, the ranks' states
    checked equal, the gradients all-reduced.  ``keep`` receives the
    state."""
    from eamm_tpu_torch.parallel import check_replicated, sync_batchnorm
    from eamm_tpu_torch.train import steps as S
    from eamm_tpu_torch.train.loop import build_models
    from eamm_tpu_torch.train.optim import make_optimizer
    tp = cfg["train_params"]
    fine_tune = mode == "train_part1_fine_tune"
    models = build_models(cfg, mode, fine_tune, seed, where)
    if synced:
        for m in models.values():
            sync_batchnorm(m)
    # the Jacobian heads start at zero weights (an identity Jacobian, a
    # Jacobian loss of rounding noise): give them the same small random
    # weights on every side
    noise = np.random.RandomState(seed + 1)
    with torch.no_grad():
        for name in ("kp_detector", "kp_detector_a"):
            w = models[name].jacobian.weight
            w.copy_(torch.from_numpy(0.005 * noise.randn(
                *w.shape).astype(np.float32)))
    for m in models.values():
        m.to(dtype)
    if synced:
        check_replicated(models, where)
    state = S.init_part1_state(models, make_optimizer, fine_tune,
                               make_optimizer if fine_tune else None)
    if keep is not None:
        keep["state"] = state
    b = S.to_device(batch, where)
    metrics, gen_out = S.part1_grads(state, tp, b)
    if fine_tune:
        metrics.update(S.discriminator_grads(state, tp, b, gen_out))
    return {
        "metrics": {k: float(v) for k, v in metrics.items()},
        "grads": {f"{n}.{k}": p.grad.double().cpu()
                  for n in (*state.trainable,
                            *(("discriminator",) if fine_tune else ()))
                  for k, p in models[n].named_parameters()},
        "stats": {f"{n}.{k}": v.double().cpu()
                  for n in state.trainable
                  for k, v in models[n].state_dict().items()
                  if k.endswith(("running_mean", "running_var"))}}


def profiled_step(step, state, batch, out: dict):
    """Take one training step under ``torch.profiler``; put into ``out``
    its wall seconds, the device time of its kernels and copies and its
    share of the wall, each of the path's kernels' time, and the kernels
    that took most."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as torch_profile
    torch.cuda.synchronize()
    with torch_profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        result = step(state, batch)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0

    def self_ms(evt):
        return getattr(evt, "self_device_time_total",
                       getattr(evt, "self_cuda_time_total", 0.0)) / 1e3

    # device work only: a user annotation (the optimizer's step) spans
    # kernels that are counted on their own
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA and self_ms(e) > 0
               and not getattr(e, "is_user_annotation", False)]
    device = sum(self_ms(e) for e in kernels)
    def of(syms):
        return [e for e in kernels if any(sym in e.key for sym in syms)]

    ours = {name: {"ms": sum(self_ms(e) for e in of(syms)),
                   "calls": sum(e.count for e in of(syms))}
            for name, syms in KERNEL_SYMBOLS.items()}
    top = sorted(kernels, key=self_ms, reverse=True)[:12]
    out["summary"] = {
        "wall_s": wall, "device_ms": device,
        "busy_share": device / (1e3 * wall),
        "kernels": ours,
        "kernels_ms": sum(v["ms"] for v in ours.values()),
        "kernels_share": (sum(v["ms"] for v in ours.values()) / device
                          if device else None),
        "top": [{"name": e.key[:100], "calls": e.count, "ms": self_ms(e)}
                for e in top]}
    return result


def step_comparison(ref: dict, cpu32):
    """(compare, grad_errors, bound) for sides of one training gradient
    (``step_gradients``' dicts) against ``ref``, the CPU's float64 side:
    ``grad_errors(side)`` is each leaf's |diff| / |reference gradient| (a
    zero gradient, a conv bias before a training-mode BatchNorm, measured
    against 1e-3 of its model's gradient norm); ``bound`` per leaf the
    larger of STEP_TOL's 1e-3 and three times the CPU float32 side's own
    error (``cpu32`` a side, or a list of sides whose largest error a
    leaf takes); ``compare(side)`` the side's worst readings against them
    and whether they refuse it (a leaf over its bound, a loss past rtol
    1e-4 or a statistic past 1e-5)."""
    totals = {}
    for k, r in ref["grads"].items():
        model = k.split(".")[0]
        totals[model] = totals.get(model, 0.0) + float((r ** 2).sum())

    def grad_errors(side: dict) -> dict:
        err = {}
        for k, r in ref["grads"].items():
            floor = max(float(r.norm()), STEP_TOL["grad_rel_l2"]
                        * totals[k.split(".")[0]] ** 0.5)
            err[k] = float((side["grads"][k] - r).norm()) / floor
        return err

    sides = cpu32 if isinstance(cpu32, list) else [cpu32]
    errors = [grad_errors(side) for side in sides]
    bound = {k: max(STEP_TOL["grad_rel_l2"], 3 * max(e[k] for e in errors))
             for k in ref["grads"]}

    def compare(side: dict) -> dict:
        err = grad_errors(side)
        over = {k: err[k] / bound[k] for k in err}
        worst = max(over, key=over.get)
        loss = max(abs(side["metrics"][k] - v) / abs(v)
                   for k, v in ref["metrics"].items())
        stats = max(float(((side["stats"][k] - r).abs()
                           / (1 + r.abs())).max())
                    for k, r in ref["stats"].items())
        return {"err": err, "loss": loss, "stats": stats,
                "grad_worst_leaf": worst, "grad_worst_over": over[worst],
                "leaves_over": sum(v > 1 for v in over.values()),
                "refused": (loss > STEP_TOL["loss_rtol"] or over[worst] > 1
                            or stats > STEP_TOL["stats"])}

    return compare, grad_errors, bound


def cpu_vs_card_step(seed: int = 0, device: str = "cuda",
                     batch_size: int = 2, faults: dict = FAULTS,
                     jaco_net: str = "cnn",
                     mode: str = "train_part1_fine_tune",
                     line: str = "train_cpu_vs_card") -> dict:
    """One ``train_part1_fine_tune`` gradient (perceptual and GAN on, then
    the discriminator's) at TINY_CONFIG widths from the same seeded
    weights and batch: on the CPU in float64 (the plain versions: the
    reference), on the CPU in float32 on each of FLOAT32_THREADS, and on
    the card in float32 (the kernels; TF32 off).  The card's losses and
    BatchNorm statistics are held to the reference within STEP_TOL, and
    each gradient leaf within STEP_TOL's relative L2 or, where float32
    itself cannot reach it, three times the largest error of the CPU's
    float32 steps on that leaf.  Float32 cannot reach 1e-3 on most
    leaves: the mimic heatmap term's gradient is 100 * weight / N *
    sign(difference) per pixel, and where both heatmaps are ~0 that sign
    is rounding noise, so float32 and float64 flip different pixels, and
    a BatchNorm parameter's gradient is a sum that cancels (the CPU's
    float32 step is 0.3-1.2% off float64 in median on the trained models,
    the discriminator's 1e-5).  The flips are random, and one summation
    order is one draw of them: the generator's final.bias is 3.2e-3 off
    on 1 and 4 threads, 5e-5 on 2 and 8, and 3.3e-3 on the card, hence
    the four orders and the margin.  As a control, the card's step is
    taken again with each of ``faults`` planted, and the comparison must
    refuse those marked so.  ``jaco_net`` picks ATNet's decoder, ``mode``
    the step (part1 has the audio losses alone), ``line`` names the
    emitted line."""
    cfg, batch = step_inputs(seed, batch_size, jaco_net, mode)
    return held_step(
        line,
        step_gradients(cfg, batch, seed, "cpu", torch.float64, mode),
        [on_threads(n, lambda: step_gradients(cfg, batch, seed, "cpu",
                                              torch.float32, mode))
         for n in FLOAT32_THREADS],
        lambda: step_gradients(cfg, batch, seed, device, torch.float32,
                               mode),
        faults)


def step_inputs(seed: int = 0, batch_size: int = 2, jaco_net: str = "cnn",
                mode: str = "train_part1_fine_tune",
                frames: int = 5) -> tuple[dict, dict]:
    """The config (TINY_CONFIG widths, one discriminator scale) and the
    seeded batch of ``cpu_vs_card_step`` (``frames`` a clip)."""
    cfg = train_config(mode, "", TINY_CONFIG, batch_size=batch_size,
                       scales=[0.25], jaco_net=jaco_net)
    cfg["model_params"]["discriminator_params"]["scales"] = [0.25]
    rng = np.random.RandomState(seed)
    B = batch_size
    T = frames
    batch = {"example_image": rng.rand(B, 256, 256, 3).astype(np.float32),
             "driving": rng.rand(B, T, 256, 256, 3).astype(np.float32),
             "driving_audio": rng.randn(B, T, 28, 12).astype(np.float32),
             "driving_pose": rng.randn(B, T, 6).astype(np.float32)}
    return cfg, batch


def on_threads(threads: int, fn):
    """``fn()`` with torch's intra-op threads set to ``threads``."""
    saved = torch.get_num_threads()
    torch.set_num_threads(threads)
    try:
        return fn()
    finally:
        torch.set_num_threads(saved)


def held_step(line: str, ref: dict, cpu32, card_side, faults: dict
              ) -> dict:
    """Hold the card's side of a training gradient (``card_side()``) to
    ``ref`` by ``step_comparison`` (``cpu32`` one CPU float32 side or a
    list of them), then take it again with each of ``faults`` planted;
    emit ``line`` with the readings and raise if the clean side is refused
    or a fault that must be refused is not."""
    compare, grad_errors, bound = step_comparison(ref, cpu32)
    sides = cpu32 if isinstance(cpu32, list) else [cpu32]
    cpu32_err = {k: max(grad_errors(side)[k] for side in sides)
                 for k in ref["grads"]}
    models = {k.split(".")[0] for k in ref["grads"]}
    clean = compare(card_side())
    card_err = clean.pop("err")
    controls = {}
    for name, (entry, scale, must_refuse) in faults.items():
        with planted_fault(entry, scale):
            reading = compare(card_side())
        del reading["err"]
        controls[name] = {**reading, "must_refuse": must_refuse,
                          "earlier_over": EARLIER_FAULT_OVER.get(
                              line, {}).get(name)}
    worst_leaf = clean["grad_worst_leaf"]
    result = {"loss": clean["loss"], "stats": clean["stats"],
              "grad_worst_leaf": worst_leaf,
              "grad_worst_err": card_err[worst_leaf],
              "grad_worst_bound": bound[worst_leaf],
              "grad_worst_over": clean["grad_worst_over"],
              "grad_leaves": len(card_err),
              "grad_leaves_within_1e-3": sum(
                  v <= STEP_TOL["grad_rel_l2"] for v in card_err.values()),
              "grad_leaves_float32_floor": sum(
                  b > STEP_TOL["grad_rel_l2"] for b in bound.values()),
              "grad_err_median": float(np.median(list(card_err.values()))),
              "grad_err_median_by_model": {
                  model: float(np.median([v for k, v in card_err.items()
                                          if k.split(".")[0] == model]))
                  for model in models},
              "cpu_float32_grad_err_median_by_model": {
                  model: float(np.median([v for k, v in cpu32_err.items()
                                          if k.split(".")[0] == model]))
                  for model in models},
              "cpu_float32_grad_err_max": max(cpu32_err.values()),
              "controls": controls}
    emit(line, losses=ref["metrics"], bounds=STEP_TOL, **result)
    missed = [name for name, c in controls.items()
              if c["must_refuse"] and not c["refused"]]
    if clean["refused"] or missed:
        raise AssertionError(f"{line}: card against CPU {result}; "
                             f"planted faults not refused: {missed}")
    return result


def bf16_step(root: str, work: str, device: str = "cuda") -> dict:
    """One fine-tune step at FULL_CONFIG in bfloat16 compute
    (``--compute_dtype bfloat16``): the losses finite."""
    from eamm_tpu_torch.cli.run import main as run_main
    from eamm_tpu_torch.train.logging import read_scalars
    cfg = train_config("train_part1_fine_tune", root, FULL_CONFIG,
                       num_repeats=8, log_every=1)
    path = os.path.join(work, "bf16.json")
    with open(path, "w") as f:
        json.dump(cfg, f)
    log = os.path.join(work, "log_bf16")
    t0 = time.perf_counter()
    run_main(["--config", path, "--mode", "train_part1_fine_tune",
              "--log_dir", log, "--max_steps", "1",
              "--compute_dtype", "bfloat16",
              *(["--cpu"] if device == "cpu" else [])])
    (run,) = os.listdir(log)
    losses = {tag: float(v[0]) for tag, (_, v) in read_scalars(
        os.path.join(log, run, "scalars.jsonl")).items()}
    if not all(np.isfinite(list(losses.values()))):
        raise AssertionError(f"bfloat16 step: {losses}")
    result = {"losses": losses, "wall_seconds": time.perf_counter() - t0}
    emit("train_bf16_step", **result)
    return result


def training_phase() -> dict:
    """Phase 8: the backward kernels against their plain versions and by
    finite differences, one TINY step on CPU and card, then both modes at
    full width through the entry point and one bfloat16 step."""
    worst = grad_parity(grad_cases())
    emit("train_finite_differences", **finite_differences())
    cpu_vs_card_step()
    return {"worst": worst, **training_runs("cuda")}


def training_runs(device: str) -> dict:
    """Both modes through the entry point on a synthetic tree, then the
    bfloat16 step; ``backward_args`` the fine-tune's first K1b and K2b
    arguments."""
    backward_args: dict = {}
    with tempfile.TemporaryDirectory() as work:
        root = os.path.join(work, "lrw")
        write_lrw_tree(root)
        runs = {mode: train_entry_point(
                    mode, root, work, device, backward_args=backward_args
                    if mode == "train_part1_fine_tune" else None)
                for mode in TRAIN_PARAMS}
        bf16_step(root, work, device)
    return {"runs": runs, "backward_args": backward_args}


# ------------------------------------- phase 9: part2 and the evaluation modes

# configs/train_part2.yaml's augmentation and train_params (the card's
# machine may lack PyYAML; tests hold these to the file)
PART2_AUGMENTATION = {
    "crop_mouth_param": {"center_x": 135, "center_y": 190, "mask_width": 100,
                         "mask_height": 60},
    "rotation_param": {"degrees": 30},
    "perspective_param": {"pers_num": 30, "enlarge_num": 40},
    "flip_param": {"horizontal_flip": True, "time_flip": False},
    "jitter_param": {"brightness": 0, "contrast": 0, "saturation": 0,
                     "hue": 0}}
PART2_PARAMS = {
    "type": "linear_4", "classify": True, "smooth": False, "jaco_net": "cnn",
    "ldmark": "fake", "generator": "not", "num_epochs": 300,
    "num_repeats": 1, "epoch_milestones": [60, 90], "lr_generator": 2.0e-4,
    "lr_discriminator": 2.0e-4, "lr_kp_detector": 2.0e-4,
    "lr_audio_feature": 2.0e-4, "batch_size": 16,
    "scales": [1, 0.5, 0.25, 0.125], "checkpoint_freq": 1, "log_every": 10,
    "steps_per_dispatch": 1,
    "transform_params": {"sigma_affine": 0.05, "sigma_tps": 0.005,
                         "points_tps": 5},
    "loss_weights": {"generator_gan": 0, "discriminator_gan": 0,
                     "feature_matching": [10, 10, 10, 10],
                     "perceptual": [10, 10, 10, 10, 10],
                     "equivariance_value": 0, "equivariance_jacobian": 0,
                     "emo": 10}}
PART2_ROWS = 16 * 16            # the YAML's batch x 16 frames: images a step
PART2_STEPS = 3                 # per run; the first warms up
# (name, type, device augmentation, resumed): the YAML's linear_4 with the
# host and the device augmentation, map_4 by override on the device one
# (the host augmentation waits ~10 s a batch on the loader: one host run
# reads it)
PART2_RUNS = (("linear_4 host", "linear_4", False, False),
              ("linear_4 device", "linear_4", True, True),
              ("map_4 device", "map_4", True, False))
PART2_KERNELS = {"linear_4": ("kp_expectation",),
                 "map_4": ("kp_expectation", "kp_expectation_backward")}
EVAL_VIDEOS = 2
# the card's reconstruction metrics against the CPU's: |difference| for
# L1 (the render's per-frame mean bound), SSIM and AKD (in [-1, 1]
# coordinates: 0.13 pixel at 256), relative for PSNR and AED
EVAL_TOL = {"l1": (3e-3, "abs"), "ssim": (1e-3, "abs"),
            "psnr": (1e-2, "rel"), "akd": (1e-3, "abs"),
            "aed": (1e-2, "rel")}
FRAME_BOUNDS = (1e-2, 3e-3)     # per-frame mean |difference| max, mean


def write_mead_tree(root: str, identities: int = 4, frames: int = 30,
                    seed: int = 12) -> None:
    """A seeded MEAD-layout tree: per identity a neutral and an emotional
    clip, each a ``frames.eammpack`` of 256x256 frames (no PNG codec
    needed), an MFCC window per frame and a pose track."""
    from eamm_tpu_torch.data.packed import write_pack
    rng = np.random.RandomState(seed)
    emotions = ("angry", "happy", "sad", "surprised")
    for i in range(identities):
        for emo in ("neutral", emotions[i % len(emotions)]):
            clip = f"M{i:03d}/{emo}_001"
            img = os.path.join(root, "MEAD_fomm_crop", clip)
            os.makedirs(img)
            write_pack(os.path.join(img, "frames.eammpack"),
                       list(range(frames)),
                       rng.randint(0, 256, (frames, 256, 256, 3), np.uint8))
            for sub, arr in (("MEAD_MFCC", rng.randn(frames, 28, 13)),
                             ("MEAD_fomm_pose_crop", rng.randn(frames, 7))):
                path = os.path.join(root, sub, clip + ".npy")
                os.makedirs(os.path.dirname(path), exist_ok=True)
                np.save(path, arr)


def part2_config(root: str, model_config: dict, etype: str,
                 device_augmentation: bool, **overrides) -> dict:
    tp = json.loads(json.dumps(PART2_PARAMS))
    tp.update(type=etype, **overrides)
    return {**json.loads(json.dumps(model_config)), "train_params": tp,
            "dataset_params": {
                "name": "MEAD", "root_dir": root,
                "frame_shape": [256, 256, 3], "id_sampling": False,
                "device_augmentation": device_augmentation,
                "augmentation_params": PART2_AUGMENTATION}}


def frozen_checkpoints(cfg: dict, work: str) -> tuple[list, dict]:
    """The reference's FOMM and audio checkpoints of part2's frozen models
    drawn from seed 5 -> (the CLI's flags, their tensors by model)."""
    from eamm_tpu_torch.train.loop import build_models
    from eamm_tpu_torch.train.steps import PART2_FROZEN
    models = build_models(cfg, "train_part2", seed=5, device="cpu")
    tensors = {n: {k: v.clone() for k, v in models[n].state_dict().items()}
               for n in PART2_FROZEN}
    fomm = os.path.join(work, "part2_fomm.pth.tar")
    audio = os.path.join(work, "part2_audio.pth.tar")
    torch.save({"kp_detector": tensors["kp_detector"]}, fomm)
    torch.save({n: tensors[n] for n in ("audio_feature", "kp_detector_a")},
               audio)
    return ["--fomm_checkpoint", fomm, "--audio_checkpoint", audio], tensors


def part2_entry_point(name: str, etype: str, device_augmentation: bool,
                      resume: bool, root: str, work: str,
                      device: str = "cuda") -> dict:
    """``eamm-torch-run --mode train_part2`` at FULL_CONFIG widths and the
    YAML's batch: PART2_STEPS steps with every launch count zeroed just
    before and read just after (K3 must launch, and K3b with map_4), each
    step's wall seconds, peak memory; every loss finite, emo_detector
    changed, the frozen models (weights and BatchNorm statistics) bit for
    bit the checkpoints'; with ``resume`` one more step from the
    checkpoint with ``--checkpoint latest``, under ``torch.profiler``
    (``profiled_step``)."""
    from eamm_tpu_torch.cli.run import main as run_main
    from eamm_tpu_torch.train.logging import read_scalars
    from eamm_tpu_torch.train.loop import build_models
    cfg = part2_config(root, FULL_CONFIG, etype, device_augmentation,
                       num_repeats=4, log_every=1)
    tag = name.replace(" ", "_")
    path = os.path.join(work, f"part2_{tag}.json")
    with open(path, "w") as f:
        json.dump(cfg, f)
    flags, frozen = frozen_checkpoints(cfg, work)
    log = os.path.join(work, f"log_part2_{tag}")
    argv = ["--config", path, "--mode", "train_part2", "--log_dir", log,
            *flags, *(["--cpu"] if device == "cpu" else [])]
    with timed_steps("make_part2_step") as (walls, profiled):
        before = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        state, counts = drive(f"train_part2 {name}", PART2_KERNELS[etype],
                              lambda: run_main(argv + ["--max_steps",
                                                       str(PART2_STEPS)]),
                              info={"steps": PART2_STEPS})
        run_seconds = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        profiled["on"] = True
        resumed = (run_main(argv + ["--max_steps", "1", "--checkpoint",
                                    "latest"]) if resume else None)
    drawn = build_models(cfg, "train_part2", seed=0, device="cpu")
    after = model_tensors(state.models)
    for n, tensors in frozen.items():
        if any(not torch.equal(v, after[n][k].cpu())
               for k, v in tensors.items()):
            raise AssertionError(f"part2 {name}: frozen {n} changed")
    if all(torch.equal(v, after["emo_detector"][k].cpu())
           for k, v in drawn["emo_detector"].state_dict().items()):
        raise AssertionError(f"part2 {name}: emo_detector did not change")
    (run,) = os.listdir(log)
    losses = {t: [float(v) for v in vals] for t, (_, vals) in read_scalars(
        os.path.join(log, run, "scalars.jsonl")).items()}
    if not all(np.isfinite(v).all() for v in losses.values()):
        raise AssertionError(f"part2 {name}: a loss is not finite {losses}")
    if state.step != PART2_STEPS or (resume and resumed.step
                                     != PART2_STEPS + 1):
        raise AssertionError(f"part2 {name}: steps {state.step}")
    result = {"run": name, "type": etype,
              "device_augmentation": device_augmentation,
              "batch": cfg["train_params"]["batch_size"], "frames": 16,
              "steps": PART2_STEPS, "step_seconds": walls[:PART2_STEPS],
              "step_seconds_median": float(np.median(
                  walls[1:PART2_STEPS])),
              "run_seconds": run_seconds, "peak_memory_allocated": peak,
              "allocated_before": before, "launches": counts,
              "launches_per_step": {k: v / PART2_STEPS
                                    for k, v in counts.items()},
              "losses": losses, "frozen_unchanged": sorted(frozen),
              "resumed_at": resumed.step if resume else None,
              "resumed_step_profile": profiled.get("summary"),
              "card": card_line()}
    emit("part2_entry_point", **result)
    return result


def part2_step_gradients(cfg: dict, batch: dict, seed: int, where: str,
                         dtype: torch.dtype) -> dict:
    """One part2 gradient on ``where`` in ``dtype``: the metrics,
    emo_detector's gradient leaves and new BatchNorm statistics, in
    float64 on the CPU (``step_gradients``' form)."""
    from eamm_tpu_torch.train import steps as S
    from eamm_tpu_torch.train.loop import build_models
    from eamm_tpu_torch.train.optim import make_optimizer
    models = build_models(cfg, "train_part2", seed=seed, device="cpu")
    noise = np.random.RandomState(seed + 1)
    with torch.no_grad():
        for m in models.values():
            for k, p in m.named_parameters():
                if "jacobian" in k and k.endswith("weight"):
                    p.copy_(torch.from_numpy(0.005 * noise.randn(
                        *p.shape).astype(np.float32)))
    for m in models.values():
        m.to(where, dtype)
    state = S.init_part2_state(models, make_optimizer)
    metrics = S.part2_grads(state, cfg["train_params"],
                            S.to_device(batch, where))
    emo = models["emo_detector"]
    return {"metrics": {k: float(v) for k, v in metrics.items()},
            "grads": {f"emo_detector.{k}": p.grad.double().cpu()
                      for k, p in emo.named_parameters()
                      if p.grad is not None},
            "stats": {f"emo_detector.{k}": v.double().cpu()
                      for k, v in emo.state_dict().items()
                      if k.endswith(("running_mean", "running_var"))}}


def part2_cpu_vs_card(seed: int = 0, device: str = "cuda") -> dict:
    """One part2 gradient (``map_4``, ``smooth`` on) at TINY widths (the
    emotion hourglass narrow) from the same seeded weights and batch (2
    clips of 3 frames), on the CPU in float64, on the CPU in float32 on
    each of FLOAT32_THREADS and on the card in float32, held as phase 8's
    step is (``held_step``): each leaf's float32 error is the largest of
    the CPU's float32 steps (four summation orders).
    A leaf's float32 error here is not one number but a spread: the
    decoder's BatchNorm biases are sums that cancel, and one summation
    order can tip a term across a kink (final.4.bias: 2e-5 on 1, 4 and 8
    threads, 6.7e-3 on 2 threads and on the card).  As a control K3b's
    Jacobian-map gradient x1.1 must be refused."""
    cfg = part2_config("", EMOTION_TINY_CONFIG, "map_4", False,
                       smooth=True)
    rng = np.random.RandomState(seed)
    B, T = 2, 3
    batch = {"example_image": rng.rand(B, 256, 256, 3).astype(np.float32),
             "driving": rng.rand(B, T, 256, 256, 3).astype(np.float32),
             "transformed_driving": rng.rand(B, T, 256, 256, 3)
             .astype(np.float32),
             "driving_audio": rng.randn(B, T, 28, 12).astype(np.float32),
             "driving_pose": rng.randn(B, T, 6).astype(np.float32),
             "emotion": np.array([1, 4], np.int32)}
    return held_step(
        "part2_cpu_vs_card",
        part2_step_gradients(cfg, batch, seed, "cpu", torch.float64),
        [on_threads(n, lambda: part2_step_gradients(cfg, batch, seed, "cpu",
                                                    torch.float32))
         for n in FLOAT32_THREADS],
        lambda: part2_step_gradients(cfg, batch, seed, device, torch.float32),
        {k: v for k, v in FAULTS.items() if k.startswith("K3b")})


def write_vox_tree(root: str, videos: int = EVAL_VIDEOS, frames: int = 24,
                   seed: int = 13) -> None:
    """A seeded Vox-layout test split of packed 256x256 clips."""
    from eamm_tpu_torch.data.packed import write_pack
    rng = np.random.RandomState(seed)
    for v in range(videos):
        name = f"id{v}/v0"
        img = os.path.join(root, "align_img", "test_fo", name)
        os.makedirs(img)
        write_pack(os.path.join(img, "frames.eammpack"), list(range(frames)),
                   rng.randint(0, 256, (frames, 256, 256, 3), np.uint8))
        for sub, arr in (("MFCC/test", rng.randn(frames, 28, 13)),
                         ("align_pose/test_fo", rng.randn(frames, 7))):
            path = os.path.join(root, sub, name + ".npy")
            os.makedirs(os.path.dirname(path), exist_ok=True)
            np.save(path, arr)


def eval_modes(work: str, device: str = "cuda") -> dict:
    """``eamm-torch-run --mode reconstruction`` (with ``--emo_checkpoint``)
    and ``--mode animate`` at FULL_CONFIG widths from seeded checkpoints
    on a Vox test split of EVAL_VIDEOS clips, on the card (launch counts
    zeroed just before each mode and read just after; K1-K3 must launch)
    and on the CPU: the card's metrics finite and within EVAL_TOL of the
    CPU's, the saved uint8 animations within FRAME_BOUNDS (per-frame mean
    |difference| in [0, 1])."""
    from eamm_tpu_torch.cli.run import main as run_main
    root = os.path.join(work, "vox")
    write_vox_tree(root)
    models = cfg.build_all(FULL_CONFIG)
    gen = torch.Generator().manual_seed(21)
    for m in models.values():
        reset_parameters(m, gen)
    paths = save_checkpoints(models, work)
    config = {**json.loads(json.dumps(FULL_CONFIG)),
              "dataset_params": {"name": "Vox", "root_dir": root,
                                 "frame_shape": [256, 256, 3]},
              "reconstruction_params": {"num_videos": EVAL_VIDEOS},
              "animate_params": {"num_pairs": EVAL_VIDEOS,
                                 "normalization_params": {
                                     "use_relative_movement": True,
                                     "adapt_movement_scale": True}}}
    path = os.path.join(work, "eval.json")
    with open(path, "w") as f:
        json.dump(config, f)
    out, launches, walls = {}, {}, {}
    for where in ("cuda", "cpu"):
        if where == "cuda" and device != "cuda":
            continue
        log = os.path.join(work, f"eval_{where}")
        argv = ["--config", path, "--log_dir", log, "--fomm_checkpoint",
                paths["fomm"], "--num_videos", str(EVAL_VIDEOS),
                *(["--cpu"] if where == "cpu" else [])]
        recon = argv + ["--mode", "reconstruction", "--emo_checkpoint",
                        paths["emo"]]
        anim = argv + ["--mode", "animate"]
        for mode, args in (("reconstruction", recon), ("animate", anim)):
            t0 = time.perf_counter()
            if where == "cuda":
                result, launches[mode] = drive(
                    f"eval {mode}", RENDER_KERNELS,
                    lambda: run_main(args))
            else:
                result = run_main(args)
            walls[f"{mode} {where}"] = time.perf_counter() - t0
            if mode == "reconstruction":
                out[where] = result
        (run,) = [r for r in os.listdir(log) if os.path.isdir(
            os.path.join(log, r, "animation"))]
        out[f"{where}_frames"] = [
            np.load(os.path.join(log, run, "animation", f"pair_{i}.npy"))
            for i in range(EVAL_VIDEOS)]
    card = out.get("cuda", out["cpu"])
    if not all(np.isfinite(v) for k, v in card.items() if k != "videos"):
        raise AssertionError(f"eval: metrics not finite {card}")
    diffs = {}
    for k, (tol, kind) in EVAL_TOL.items():
        a, b = card[f"reconstruction_{k}"], out["cpu"][f"reconstruction_{k}"]
        d = abs(a - b) / (abs(b) if kind == "rel" else 1.0)
        diffs[k] = d
        if d > tol:
            raise AssertionError(f"eval: {k} card {a} CPU {b}")
    frames = []
    for a, b in zip(out.get("cuda_frames", out["cpu_frames"]),
                    out["cpu_frames"]):
        per = np.abs(a.astype(np.float64) - b).mean(axis=(1, 2, 3)) / 255.0
        frames.append({"max": float(per.max()), "mean": float(per.mean())})
        if per.max() >= FRAME_BOUNDS[0] or per.mean() >= FRAME_BOUNDS[1]:
            raise AssertionError(f"eval: animation frames {frames}")
    result = {"metrics_card": card, "metrics_cpu": out["cpu"],
              "metric_differences": diffs, "bounds": EVAL_TOL,
              "animation_frame_diff": frames, "launches": launches,
              "wall_seconds": walls, "card": card_line()}
    emit("eval_modes", **result)
    return result


def part2_phase(device: str = "cuda") -> dict:
    """Phase 9: the TINY part2 gradient on CPU and card, the three part2
    runs at full width through the entry point, the evaluation modes."""
    part2_cpu_vs_card(device=device)
    with tempfile.TemporaryDirectory() as work:
        root = os.path.join(work, "mead")
        write_mead_tree(root)
        runs = {name: part2_entry_point(name, etype, aug, resume, root,
                                        work, device)
                for name, etype, aug, resume in PART2_RUNS}
        evaluation = eval_modes(work, device)
    return {"runs": runs, "eval": evaluation}


# ------------------------------------------------ phase 10: the gan A2FD

GAN_SECONDS = (4.0, 10.0)
GAN_TRAIN_STEPS = 2             # then one more, resumed: three steps
GAN_ARTIFACT_FRAMES = 32        # the artifact program's bucket (a 1 s clip)
GAN_FAULTS = {k: FAULTS[k] for k in ("K3b_grad_jmap_x1.1",)}


def with_gan_atnet(pipe: EammPipeline, seed: int = 0) -> EammPipeline:
    """``pipe``'s models with ATNet replaced by a gan ATNet drawn from
    ``seed`` (``reset_parameters``), under ``pipe``'s options and config
    with ``jaco_net: gan``: the two routes differ in ATNet alone.  (A gan
    config drawn whole by ``from_random`` gives the other models other
    weights, since the synthesis network takes its own draws first.)"""
    config = {**pipe.config, "train_params": {"jaco_net": "gan"}}
    atnet = cfg.build_atnet(config)
    reset_parameters(atnet, torch.Generator().manual_seed(seed))
    return EammPipeline(config, models={**pipe.models,
                                        "audio_feature": atnet},
                        options=pipe.options)


def gan_renders(gan: EammPipeline, cnn: EammPipeline) -> dict:
    """Neutral and emotional (linear_3, EMOTION_FRAMES frames) requests of
    4 s and 10 s through ``render_uint8``, bfloat16 generator, on the gan
    pipeline and on phase 5's cnn pipeline in turn (cnn, gan): each one's
    wall seconds, fps and peak device memory, and its launches (K1-K3 must
    launch); the 4 s clips in float32, bfloat16 within phase 5's bounds of
    them; a 4 s float32 neutral stream in chunks of STREAM_FRAMES within
    one count of the whole clip -> {'rows', 'launches'}."""
    video = emotion_clip(EMOTION_FRAMES, 7)
    for p in (cnn, gan):                # warm-up of both routes, not counted
        p.render_uint8(*clip_inputs(1.0, 100), add_emo=False)
        p.render_uint8(*clip_inputs(4.0, 100), video)
    rows, launches = {}, {}
    kinds = {"neutral": (None, False), "emotional": (video, True)}
    for kind, args in kinds.items():
        for seconds in GAN_SECONDS:
            clip = clip_inputs(seconds, 1)
            key = f"{kind} {seconds:g} s"
            for route, p in (("cnn", cnn), ("gan", gan)):
                torch.cuda.reset_peak_memory_stats()
                _, counts = drive(f"phase 10 {route} {kind}", RENDER_KERNELS,
                                  lambda: p.render_uint8(*clip, *args),
                                  seconds)
                row = REQUESTS[-1]
                rows.setdefault(key, {})[route] = {
                    "wall_seconds": row["wall_seconds"], "fps": row["fps"],
                    "peak_memory_allocated": torch.cuda.max_memory_allocated()}
                if route == "gan":
                    launches[f"gan {key}"] = counts
    clip = clip_inputs(4.0, 2)
    f32 = with_options(gan, compute_dtype=torch.float32)
    for (kind, args), (mean, p99) in zip(kinds.items(),
                                         ((0.5, 2.0), (0.75, 3.0))):
        quality = uint8_diff(gan.render_uint8(*clip, *args),
                             f32.render_uint8(*clip, *args))
        emit("bf16_vs_f32", path=f"gan {kind}", clip_seconds=4.0,
             uint8_diff=quality)
        if not (quality["mean"] < mean and quality["p99"] <= p99):
            raise AssertionError(f"gan bf16 {kind} render strays from f32: "
                                 f"{quality}")
    chunks = with_options(f32, segment_frames=STREAM_FRAMES)
    list(chunks.render_stream(*clip_inputs(1.0, 100), add_emo=False))
    whole = f32.render_uint8(*clip, add_emo=False)
    info = {}
    out, launches["gan unbounded f32 neutral 4 s"] = drive(
        "gan unbounded f32 neutral", RENDER_KERNELS,
        lambda: joined(chunks.render_stream(*clip, add_emo=False), info),
        4.0, info)
    diff = uint8_diff(out, whole)
    emit("unbounded_vs_whole", path="gan neutral", dtype="float32",
         clip_seconds=4.0, uint8_diff=diff)
    if out.shape != whole.shape or diff["max"] > 1.0:
        raise AssertionError(f"gan unbounded stream strays from the whole "
                             f"clip: {diff}")
    return {"rows": rows, "launches": launches}


@torch.no_grad()
def atnet_share(pipe: EammPipeline, seconds: float = 10.0,
                rounds: int = 3) -> dict:
    """Wall ms (ended by a synchronize) of the neutral keypoint stage of a
    ``seconds`` clip and of ATNet's part of it (the identity encoder, the
    window encoders, the LSTM and the decoder over every window), in
    turns (stage, ATNet, ATNet, stage per round) -> medians and ATNet's
    share."""
    T, source, wav, pose = pipe._prepare(*clip_inputs(seconds, 1))
    windows = audio_to_mfcc_windows(wav)[:pose.shape[0]]
    atnet = pipe.models["audio_feature"]
    fns = {"kp_stage": lambda: pipe._kp_stage(source, wav, pose, None,
                                              False),
           "atnet": lambda: atnet(source, windows[None], pose[None],
                                  audio_weight=pipe.options.audio_weight)}
    samples = {name: [] for name in fns}
    for fn in fns.values():
        fn()
    for _ in range(rounds):
        for name in ("kp_stage", "atnet", "atnet", "kp_stage"):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fns[name]()
            torch.cuda.synchronize()
            samples[name].append(1e3 * (time.perf_counter() - t0))
    med = {name: float(np.median(v)) for name, v in samples.items()}
    return {"windows": int(pose.shape[0]), "kp_stage_ms": med["kp_stage"],
            "atnet_ms": med["atnet"],
            "atnet_share": med["atnet"] / med["kp_stage"]}


def gan_serving(gan: EammPipeline, work: str, device: str = "cuda") -> dict:
    """The gan models saved as the reference's files (the audio file with
    the deconv decoder the reference holds), preflighted and loaded back
    through ``from_torch_checkpoints`` (bf16, yuv420); one 4 s neutral
    request through a ``RenderServer`` on them, the call the worker made
    made again on this thread and held to its result bit for bit, the
    client's payload to its part of it -> the call's launches."""
    from eamm_tpu_torch.serve import RenderServer
    opts = PipelineOptions(frame_chunk=32, time_bucket=32,
                           compute_dtype=torch.bfloat16,
                           transfer_format="yuv420", device=device)
    _, loaded = checkpoint_path(gan, work, opts)
    rec = Recorder(loaded)
    server = RenderServer(loaded, max_batch=1, max_delay_ms=0.0)
    clip = clip_inputs(SERVE_SECONDS, 900)
    try:
        t0 = time.perf_counter()
        payload = server.render(*clip, timeout=600)
        wall = time.perf_counter() - t0
    finally:
        server.stop()
    call, row = served_by(rec.calls, clip[1])
    same_bits(tuple(rec.replay(call)), tuple(call["result"]),
              "gan served call against the same call again")
    T = num_windows_for_samples(len(clip[1]))
    want = tuple(p[row, :T] if row is not None else p[:T]
                 for p in call["result"])
    got = payload if isinstance(payload, tuple) else _planes(payload)
    same_bits(got, want, "gan client payload")
    frames_out(got)
    missing = [k for k in RENDER_KERNELS if call["launches"][k] <= 0]
    emit("gan_serving", method=call["method"], wall_seconds=wall, frames=T,
         launches=call["launches"], ignored_keys=loaded.ignored_keys)
    if missing:
        raise AssertionError(f"gan served call: not launched: {missing}")
    return call["launches"]


def gan_artifact(gan: EammPipeline, work: str, device: str = "cuda") -> dict:
    """One batched program of the gan pipeline (batch 1, bucket
    GAN_ARTIFACT_FRAMES, bf16, yuv420) exported on the card, loaded back
    and run on a seeded 1 s clip's inputs: bitwise the live pipeline's
    function on the same inputs -> the program's launches."""
    from eamm_tpu_torch.infer import export as ex
    live = EammPipeline(gan.config, models=gan.models, options=PipelineOptions(
        frame_chunk=32, time_bucket=32, compute_dtype=torch.bfloat16,
        transfer_format="yuv420", device=device))
    path = os.path.join(work, "gan.eammx")
    t0 = time.perf_counter()
    ex.export_render_artifact(live, path, batch=1,
                              frame_buckets=(GAN_ARTIFACT_FRAMES,))
    export_s = time.perf_counter() - t0
    art = ex.RenderArtifact.load(path, device)
    _, srcs, wins, poses = art._prepare_batch(*zip(clip_inputs(1.0, 910)))
    name = f"1x{GAN_ARTIFACT_FRAMES}"
    torch.cuda.synchronize()
    reset_launch_counts()
    got = art._call(name, srcs, wins, poses)
    torch.cuda.synchronize()
    launches = launch_counts()
    want = live._batch_render_impl(srcs, wins, poses)
    if len(got) != len(want) or not all(torch.equal(a, b)
                                        for a, b in zip(got, want)):
        raise AssertionError(f"gan artifact program {name}: not bitwise "
                             "the live call")
    emit("gan_artifact", program=name, export_seconds=export_s,
         bytes=os.path.getsize(path), launches=launches)
    missing = [k for k in RENDER_KERNELS if launches[k] <= 0]
    if missing:
        raise AssertionError(f"gan artifact program: not launched: "
                             f"{missing}")
    return launches


def write_png_rows(path: str, image: np.ndarray) -> None:
    """An 8-bit grey, RGB or RGBA PNG of ``image`` [H, W, 1 | 3 | 4] by
    the standard library, row y filtered by filter y % 5 (None, Sub, Up,
    Average, Paeth), so that a decoder has to undo all five."""
    import struct
    import zlib
    h, w, bpp = image.shape
    rows = image.reshape(h, w * bpp).astype(np.int64)
    body, prev = bytearray(), np.zeros(w * bpp, np.int64)
    for y in range(h):
        line, kind = rows[y], y % 5
        left = np.concatenate([np.zeros(bpp, np.int64), line[:-bpp]])
        upleft = np.concatenate([np.zeros(bpp, np.int64), prev[:-bpp]])
        p = left + prev - upleft
        pa, pb, pc = (np.abs(p - left), np.abs(p - prev),
                      np.abs(p - upleft))
        paeth = np.where((pa <= pb) & (pa <= pc), left,
                         np.where(pb <= pc, prev, upleft))
        pred = (0, left, prev, (left + prev) // 2, paeth)[kind]
        body.append(kind)
        body += bytes(((line - pred) & 255).astype(np.uint8))
        prev = line

    def chunk(kind: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + kind + data
                + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))

    color = {1: 0, 3: 2, 4: 6}[bpp]
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n"
                + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, color, 0,
                                             0, 0))
                + chunk(b"IDAT", zlib.compress(bytes(body)))
                + chunk(b"IEND", b""))


def native_decoder_check(work: str) -> dict:
    """Which route ``decode_batch`` takes here (the native library, else
    imageio, else the standard library's zlib), and a seeded batch of 9
    64x48 PNGs (grey, RGB and RGBA, rows filtered by all five filters,
    ``write_png_rows``) decoded through the zlib route, held bitwise to
    the images written (scaled by float32 1/255, grey repeated to RGB,
    alpha dropped); where the library built, its decode of the batch
    bitwise the zlib route's too."""
    from eamm_tpu_torch.data import native
    rng = np.random.RandomState(12)
    paths, want = [], []
    for i in range(9):
        c = (1, 3, 4)[i % 3]
        img = (rng.rand(64, 48, c) * 255).astype(np.uint8)
        paths.append(os.path.join(work, f"{i}.png"))
        write_png_rows(paths[-1], img)
        rgb = img[..., :3] if c >= 3 else np.repeat(img, 3, axis=2)
        want.append(rgb.astype(np.float32) * (np.float32(1) / np.float32(255)))
    built = native.native_available()
    result = {"built": built, "route": native.route(),
              "build_error": native.build_error(), "files": len(paths),
              "channels": [1, 3, 4]}
    t0 = time.perf_counter()
    out = native.decode_zlib(paths, 64, 48)
    result["seconds"] = time.perf_counter() - t0
    result["decoded"] = True
    result["max_abs_err"] = float(np.abs(out - np.stack(want)).max())
    if built:
        result["native_bitwise"] = bool(np.array_equal(
            native.decode_batch(paths, 64, 48).view(np.uint32),
            out.view(np.uint32)))
    emit("native_decoder", **result)
    if result["max_abs_err"] != 0 or result.get("native_bitwise") is False:
        raise AssertionError(f"the zlib PNG route: {result}")
    return result


def gan_phase(cnn: EammPipeline, device: str = "cuda") -> dict:
    """Phase 10: the ``jaco_net: gan`` A2FD at FULL_CONFIG beside phase 5's
    cnn pipeline ``cnn`` -> {'launches': path -> counts}."""
    t_phase = time.perf_counter()
    for result in cpu_vs_device(device, 0, with_gan_atnet).values():
        emit("gan_cpu_vs_card", **result)
    t0 = time.perf_counter()
    gan = with_gan_atnet(cnn)
    torch.cuda.synchronize()
    emit("gan_setup", seconds=time.perf_counter() - t0)
    renders = gan_renders(gan, cnn)
    launches = dict(renders["launches"])
    share = {route: atnet_share(p) for route, p in (("cnn", cnn),
                                                   ("gan", gan))}
    emit("gan_vs_cnn", renders=renders["rows"], atnet_share=share,
         card=card_line())
    with tempfile.TemporaryDirectory() as work:
        # the served call and the artifact's program are held bitwise to
        # the same call made again: with cuDNN's deterministic algorithms,
        # as phase 7 (the default ones for some of ATNet's layers are not)
        deterministic = torch.backends.cudnn.deterministic
        torch.backends.cudnn.deterministic = True
        try:
            launches["gan served 4 s"] = gan_serving(gan, work, device)
            launches["gan artifact 1 s"] = gan_artifact(gan, work, device)
        finally:
            torch.backends.cudnn.deterministic = deterministic
        root = os.path.join(work, "lrw")
        write_lrw_tree(root)
        run = train_entry_point("train_part1", root, work, device,
                                steps=GAN_TRAIN_STEPS, jaco_net="gan")
        launches["gan train_part1 per step"] = run["launches_per_step"]
        native_decoder_check(work)
    cpu_vs_card_step(device=device, faults=GAN_FAULTS, jaco_net="gan",
                     mode="train_part1", line="gan_train_cpu_vs_card")
    emit("gan_phase", seconds=time.perf_counter() - t_phase,
         card=card_line())
    return {"launches": launches}


# ---------------------------------------------------------------- phase 11

K6_B = 128                      # K6's own shape: one 128-frame chunk


def k6_case(Bi: int, B: int, hw: tuple[int, int], dtype: torch.dtype,
            gen: torch.Generator):
    """A random [Bi,64,64,256] image in ``dtype`` and a [B,*hw,2] grid in
    U(-1.05, 1.05) in the image dtype (K6's bench passes bfloat16 grids)."""
    image = torch.randn((Bi, 64, 64, 256), generator=gen, device="cuda"
                        ).to(dtype)
    grid = torch.rand((B, *hw, 2), generator=gen, device="cuda") * 2.1 - 1.05
    return image, grid.to(dtype)


def k6_parity() -> float:
    """K6 against its plain version on the card: bfloat16 and float32
    images at K6's own shape, at Bi = 2 and over ragged 13 x 17 outputs.
    Bitwise: no element may differ (each line counts those that do), and
    none by more than one bfloat16 ulp at the image's scale.  K1, or a K6
    that skips the bfloat16 rounding of the y pass, moves outputs by up
    to half such an ulp, so only the count of differing elements tells
    them apart.  Returns the largest |error|."""
    gen = torch.Generator(device="cuda").manual_seed(11)
    wrapper, plain = KERNELS["warp_wide_b16"][:2]
    worst = 0.0
    for dtype in (torch.bfloat16, torch.float32):
        for Bi, B, hw in ((1, K6_B, (64, 64)), (2, K6_B, (64, 64)),
                          (2, 4, (13, 17))):
            image, grid = k6_case(Bi, B, hw, dtype, gen)
            got, want = wrapper(image, grid), plain(image, grid)
            torch.cuda.synchronize()
            err = (got.float() - want.float()).abs()
            ulp = 2.0 ** (np.floor(np.log2(image.float().abs().max().item()))
                          - 7)
            line = {"dtype": str(dtype), "image": list(image.shape),
                    "grid": list(grid.shape), "max_abs_err": err.max().item(),
                    "differ": int((err > 0).sum().item()),
                    "elements": got.numel(), "bf16_ulp_at_scale": ulp}
            emit("k6_parity", **line)
            if line["differ"] or line["max_abs_err"] > ulp:
                raise AssertionError(f"K6 strays from its plain version: "
                                     f"{line}")
            worst = max(worst, line["max_abs_err"])
            del got, want, err
    return worst


MESH_SECONDS = 4.0               # the meshed renders' clip
MESH_TRAIN_STEPS = 2             # the distributed loop's steps at FULL
MESH_FAULTS = {k: FAULTS[k] for k in ("K3b_grad_jmap_x1.1",)}


def free_port() -> int:
    """A free TCP port on the loopback for a process group's rendezvous."""
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@contextlib.contextmanager
def torchrun_variables(port: int):
    """torchrun's variables of a one-process group (rank 0 of 1) while the
    block runs, as ``eamm-torch-run`` reads them."""
    names = {"RANK": "0", "WORLD_SIZE": "1", "LOCAL_RANK": "0",
             "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(port)}
    saved = {k: os.environ.get(k) for k in names}
    os.environ.update(names)
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def mesh_step(device: str = "cuda") -> dict:
    """The TINY ``train_part1`` gradient of a distributed run at world
    size 1 over NCCL (BatchNorm over the global batch by one all-reduce a
    layer, the gradients all-reduced) on the card, held to the CPU's
    float64 step by ``held_step``'s per-leaf bounds, K3b's planted fault
    refused.  The CPU sides run before the group exists (its NCCL
    backend takes CUDA tensors only)."""
    import torch.distributed as dist
    from eamm_tpu_torch.parallel import init_distributed
    cfg, batch = step_inputs(0, 2, "cnn", "train_part1")
    ref = step_gradients(cfg, batch, 0, "cpu", torch.float64, "train_part1")
    cpu32 = [on_threads(n, lambda: step_gradients(
        cfg, batch, 0, "cpu", torch.float32, "train_part1"))
        for n in FLOAT32_THREADS]
    init_distributed(0, 1, f"tcp://127.0.0.1:{free_port()}", device)
    try:
        return held_step("mesh_train_cpu_vs_card", ref, cpu32,
                         lambda: step_gradients(cfg, batch, 0, device,
                                                torch.float32, "train_part1",
                                                synced=True),
                         MESH_FAULTS if device == "cuda" else {})
    finally:
        dist.destroy_process_group()


def mesh_renders(pipe: EammPipeline, device: str = "cuda:0") -> dict:
    """A neutral 4 s clip through ``use_mesh([cuda:0])`` and with
    ``time_shard=True``, and a batch of 2 through the mesh, each bitwise
    the same call on ``pipe``; K1-K3 must launch on each.  -> path ->
    launch counts."""
    clip = clip_inputs(MESH_SECONDS, 30)
    want = pipe.render_uint8(*clip, add_emo=False)
    launches = {}
    for path, time_shard in (("mesh", False), ("mesh time_shard", True)):
        meshed = with_options(pipe).use_mesh([device], time_shard)
        got, launches[path] = drive(
            path, RENDER_KERNELS,
            lambda: meshed.render_uint8(*clip, add_emo=False), MESH_SECONDS)
        same_bits(got, want, f"{path} against render_uint8")
    srcs, wavs, poses = batch_inputs()
    srcs, wavs, poses = srcs[:2], wavs[:2], poses[:2]
    want = pipe.render_batch_uint8(srcs, wavs, poses)
    meshed = with_options(pipe).use_mesh([device])
    got, launches["mesh batch"] = drive(
        "mesh batch", RENDER_KERNELS,
        lambda: meshed.render_batch_uint8(srcs, wavs, poses))
    same_bits(got, want, "mesh batch against render_batch_uint8")
    return launches


def mesh_training(unsharded: dict, device: str = "cuda") -> dict:
    """``eamm-torch-run --mode train_part1`` under torchrun's variables
    (one process, NCCL) at FULL_CONFIG and the YAML's batch:
    MESH_TRAIN_STEPS steps with the launch counts zeroed just before and
    read just after (K3 and K3b must launch), each step's wall seconds,
    the peak memory and every loss finite, beside phase 8's unsharded
    part1 run (``unsharded``)."""
    from eamm_tpu_torch.cli.run import main as run_main
    from eamm_tpu_torch.train.logging import read_scalars
    with tempfile.TemporaryDirectory() as work:
        root = os.path.join(work, "lrw")
        write_lrw_tree(root)
        cfg = train_config("train_part1", root, FULL_CONFIG, num_repeats=8,
                           log_every=1)
        path = os.path.join(work, "mesh.json")
        with open(path, "w") as f:
            json.dump(cfg, f)
        log = os.path.join(work, "log_mesh")
        with timed_steps("make_part1_step") as (walls, _), \
                torchrun_variables(free_port()):
            torch.cuda.reset_peak_memory_stats()
            state, counts = drive(
                "distributed train_part1", MODE_KERNELS["train_part1"],
                lambda: run_main(["--config", path, "--mode", "train_part1",
                                  "--log_dir", log, "--max_steps",
                                  str(MESH_TRAIN_STEPS),
                                  *(["--cpu"] if device == "cpu" else [])]),
                info={"steps": MESH_TRAIN_STEPS, "world_size": 1})
            peak = torch.cuda.max_memory_allocated()
        (run,) = os.listdir(log)
        losses = {tag: [float(v) for v in vals] for tag, (_, vals) in
                  read_scalars(os.path.join(log, run, "scalars.jsonl"))
                  .items()}
    if state.step != MESH_TRAIN_STEPS or not all(
            np.isfinite(v).all() for v in losses.values()):
        raise AssertionError(f"distributed train_part1: steps {state.step}, "
                             f"losses {losses}")
    result = {"world_size": 1,
              "backend": "gloo" if device == "cpu" else "nccl",
              "batch": cfg["train_params"]["batch_size"], "frames": 16,
              "steps": MESH_TRAIN_STEPS, "step_seconds": walls,
              "peak_memory_allocated": peak, "losses": losses,
              "launches_per_step": {k: v / MESH_TRAIN_STEPS
                                    for k, v in counts.items()},
              "unsharded_step_seconds_median":
                  unsharded["step_seconds_median"],
              "unsharded_peak_memory_allocated":
                  unsharded["peak_memory_allocated"],
              "card": card_line()}
    emit("mesh_train_entry_point", **result)
    return result


def mesh_phase(pipe: EammPipeline, unsharded: dict,
               device: str = "cuda") -> dict:
    """Phase 11: K6 against its plain version, then the mesh at world size
    1 on the card: the TINY distributed step against the CPU, the meshed
    renders, the distributed loop at FULL_CONFIG.  -> {'k6_worst',
    'launches': path -> counts, 'train'}."""
    t_phase = time.perf_counter()
    worst = k6_parity() if device == "cuda" else 0.0
    step = mesh_step(device)
    launches = mesh_renders(pipe, f"{device}:0" if device == "cuda"
                            else device)
    train = mesh_training(unsharded, device)
    launches["distributed train_part1 per step"] = train["launches_per_step"]
    emit("mesh_phase", seconds=time.perf_counter() - t_phase,
         train_step_over=step["grad_worst_over"], card=card_line())
    return {"k6_worst": worst, "launches": launches, "train": train}


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

    def replay():
        graph.replay()
    # the graph reads and writes the tensors that fn holds (made outside
    # the graph's pool) at their addresses: they must live as long as the
    # replay, or the next capture's empty_cache may unmap them
    replay.fn = fn
    return replay, calls


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
    out["warp_wide_b16"] = k6_timings(gen)
    return {**out, **kp_timings(gen)}


def k6_timings(gen: torch.Generator) -> dict:
    """K6 at its own shape (bfloat16 [1,64,64,256] by a bfloat16
    [128,64,64,2] grid in U(-1.05, 1.05)), in the same turns as K1 on the
    same inputs, F.grid_sample on the expanded NCHW view (which rounds
    once, with no bfloat16 rows: not the same function) and the
    store-only kernel; device ms by CUDA graph replay and the eager calls.
    Bound: each input read once and the output written once, against 9
    operations an output value (two rows of two products and a sum, the x
    pass's two products and a sum)."""
    wrapper, plain = KERNELS["warp_wide_b16"][:2]
    image, grid = k6_case(1, K6_B, (64, 64), torch.bfloat16, gen)
    res = wrapper(image, grid)
    sink = torch.empty_like(res)
    nchw = image.permute(0, 3, 1, 2).expand(K6_B, -1, -1, -1)
    fns = {"ms": lambda: wrapper(image, grid),
           "warp_wide_ms": lambda: warp_cuda.grid_sample_wide(image, grid),
           "library_ms": lambda: F.grid_sample(
               nchw, grid, mode="bilinear", padding_mode="zeros",
               align_corners=False),
           "store_ms": lambda: warp_cuda.store_only(sink)}
    device = in_turns({k: graphed(f) for k, f in fns.items()})
    eager = in_turns({"call_ms": (fns["ms"], 1),
                      "library_call_ms": (fns["library_ms"], 1),
                      "store_call_ms": (fns["store_ms"], 1)})
    bound = bound_ms(nbytes(image, grid, res), 9 * res.numel())
    return {"ms": device["ms"]["median"],
            "plain_ms": time_ms(lambda: plain(image, grid)),
            "library_ms": device["library_ms"]["median"], "bound": bound,
            "timing": {**device, **eager, "shapes": [list(image.shape),
                                                     list(grid.shape)],
                       "share": bound[0] / device["ms"]["median"]}}


def warp_backward_bound(args: tuple, grads: tuple, accumulator=False):
    """A warp backward's bound: bytes at 3.35 TB/s, each input read once
    (the image only for the grid's sum) and each gradient written once,
    against 2 operations per (pixel, corner, channel) for each gradient at
    67 TFLOP/s; with ``accumulator``, the float32 accumulator of K2b's
    first design counted as zeroed, read and written once per
    element (the atomics' read-modify-write; for a float32 image the
    accumulator is the gradient) and a bfloat16 gradient's rounding pass,
    the traffic that design could not avoid."""
    grad_out, image, grid, _, need_image, need_grid = args
    grad_image, grad_grid = grads
    n_bytes = nbytes(grad_out, grid, grad_grid)
    if need_grid:
        n_bytes += nbytes(image)
    if need_image:
        if accumulator:
            n_bytes += 3 * 4 * image.numel()
            if grad_image.dtype != torch.float32:
                n_bytes += 4 * image.numel() + nbytes(grad_image)
        else:
            n_bytes += nbytes(grad_image)
    return bound_ms(n_bytes, grad_out.numel() * 4 * (2 * need_image
                                                      + 2 * need_grid))


def backward_extra_timings(args: tuple, library, wrapper,
                           captured: tuple | None) -> dict:
    """K1b or K2b beyond its row's random grid, in turns with the
    library's ``aten.grid_sampler_2d_backward`` on the same inputs: a
    near-identity grid at the row's shape and gradients, the fine-tune
    step's own arguments (``captured``, from phase 8), and the row's
    random inputs with the image gradient alone, the grid gradient alone
    and both; each {median, min, max} ms with its bound (each input read
    once and each gradient written once; with both gradients K2b also
    carries ``bound_accumulator``, its first design's floor)."""
    gen = torch.Generator(device="cuda").manual_seed(7)
    grad_out, image, grid = args[:3]
    inputs = {"near_identity": warp_grad_case(
        image.shape[0], grid.shape[0], image.shape[3], image.dtype, gen,
        need=args[4:], grid="near_identity")}
    if captured is not None:
        inputs["captured"] = captured
    inputs["image_only"] = args[:4] + (True, False)
    inputs["grid_only"] = args[:4] + (False, True)
    inputs["both"] = args[:4] + (True, True)
    fns = {}
    for key, a in inputs.items():
        fns[key] = graphed(lambda a=a: wrapper(*a))
        if key in ("near_identity", "captured"):
            fns[f"{key}_library"] = graphed(library(a))
    times = in_turns(fns)
    out = {}
    for key, a in inputs.items():
        grads = wrapper(*a)
        bound, by = warp_backward_bound(a, grads)
        out[key] = {**times[key], "bound_ms": bound, "bound_by": by,
                    "share": bound / times[key]["median"],
                    "library_ms": times.get(f"{key}_library"),
                    "shapes": [list(t.shape) for t in a[:3]],
                    "dtypes": [str(t.dtype) for t in a[:3]],
                    "flags": list(a[3:])}
        if key == "both" and image.shape[3] <= 8:
            bound, by = warp_backward_bound(a, grads, accumulator=True)
            out[key]["bound_accumulator"] = {
                "bound_ms": bound, "bound_by": by,
                "share": bound / times[key]["median"]}
    return out


def backward_timings(captured: dict | None = None) -> dict:
    """The backward kernels at the fine-tune step's shapes, float32 (B 6,
    4 supervised frames, 96 keypoint rows), with the gradients the
    training path asks for (K1b both, K2b the grid's): device ms by CUDA
    graph replay in turns with the library call of the same gradient
    (``aten.grid_sampler_2d_backward``; K3b has none), the plain version
    eager, and the bound (``warp_backward_bound``).  K1b and K2b add
    ``backward_extra_timings`` (at ``captured``'s arguments, the fine-tune
    step's own, when given) and the attribution by the gradients asked
    for, K2b its launch plan; K3b its ``map_4`` shape and its launch
    plan."""
    gen = torch.Generator(device="cuda").manual_seed(6)
    out = {}
    for name, Bi, group, C, need in (
            ("warp_wide_backward", 24, 1, 256, (True, True)),
            ("warp_narrow_backward", 24, 11, 3, (False, True))):
        args = warp_grad_case(Bi, Bi * group, C, torch.float32, gen,
                              need=need)
        wrapper, plain = BACKWARD_KERNELS[name][:2]

        def library(a):
            # one image per grid: each source repeated for the grids that
            # read it (made once, outside the timing)
            grad_out, image, grid, align, need_image, need_grid = a
            nchw = image.permute(0, 3, 1, 2).repeat_interleave(
                grid.shape[0] // image.shape[0], dim=0)
            gout = grad_out.to(image.dtype).permute(0, 3, 1, 2)
            g = grid.to(image.dtype)
            return lambda: torch.ops.aten.grid_sampler_2d_backward(
                gout, nchw, g, 0, 0, align, [need_image, need_grid])

        times = in_turns({"ms": graphed(lambda: wrapper(*args)),
                          "library_ms": graphed(library(args))})
        grads = wrapper(*args)
        timing = dict(times)
        timing.update(backward_extra_timings(
            args, library, wrapper, (captured or {}).get(name)))
        timing["attribution"] = {
            "image_only_ms": timing["image_only"]["median"],
            "grid_only_ms": timing["grid_only"]["median"],
            "both_ms": timing["both"]["median"]}
        if name == "warp_narrow_backward":
            timing["plan"] = dataclasses.asdict(
                warp_cuda.narrow_backward_launch_plan(*args[1:3], *args[4:]))
        out[name] = {"ms": times["ms"]["median"],
                     "library_ms": times["library_ms"]["median"],
                     "plain_ms": time_ms(lambda: plain(*args)),
                     "bound": warp_backward_bound(args, grads),
                     "timing": timing}
    wrapper, plain = BACKWARD_KERNELS["kp_expectation_backward"][:2]

    def k3b_bound(args):
        # read pred and jmap, the output gradients; write both gradients;
        # ~30 operations a pixel (the division, exp, the 4-term sum, the
        # outputs)
        return bound_ms(2 * nbytes(*args[:2]) + nbytes(*args[3:]),
                        30 * args[0].numel())

    args = kp_grad_case(96, gen)
    # part2's map_4 head: 256 images of 4 rows, in the same turns
    map4 = kp_grad_case(PART2_ROWS, gen, K=4)
    times = in_turns({"ms": graphed(lambda: wrapper(*args)),
                      "map_4_ms": graphed(lambda: wrapper(*map4))})
    bound, by = k3b_bound(map4)
    row_bound = k3b_bound(args)
    out["kp_expectation_backward"] = {
        "ms": times["ms"]["median"], "library_ms": None,
        "plain_ms": time_ms(lambda: plain(*args)),
        "bound": row_bound,
        "timing": {**times, "share": row_bound[0] / times["ms"]["median"],
                   "plan": dataclasses.asdict(kpx.backward_launch_plan(
                       args[0])),
                   "map_4": {
                       "shape": [list(map4[0].shape), list(map4[1].shape)],
                       "ms": times["map_4_ms"]["median"],
                       "plain_ms": time_ms(lambda: plain(*map4)),
                       "bound_ms": bound, "bound_by": by,
                       "share": bound / times["map_4_ms"]["median"]}}}
    return out


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
    training = training_phase()
    part2 = part2_phase()
    gan = gan_phase(pipe)
    mesh = mesh_phase(pipe, training["runs"]["train_part1"])
    times = {**timings(captured),
             **backward_timings(training["backward_args"])}

    # whose launches each row counts
    source_of = {name: ("emotional linear_3 frames 10 s", counts["frames"])
                 for name in RENDER_KERNELS}
    source_of["kp_expectation"] = ("emotional map frames 4 s", counts["map"])
    for name in ("warp_shared", "kp_expectation_fused", "warp_wide_b16"):
        source_of[name] = ("entry points", entry)
    fine_tune = training["runs"]["train_part1_fine_tune"]
    for name in BACKWARD_KERNELS:
        source_of[name] = (f"train_part1_fine_tune {TRAIN_STEPS} steps",
                           fine_tune["launches"])
    worst.update(training["worst"])
    worst["warp_wide_b16"] = mesh["k6_worst"]
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
                     "launches_per_train_step": {
                         mode: run["launches_per_step"][name]
                         for mode, run in training["runs"].items()},
                     "max_abs_err": worst[name], "ms": t["ms"],
                     "plain_ms": t["plain_ms"], "bound_ms": t["bound"][0],
                     "bound_by": t["bound"][1], "library_ms": t["library_ms"],
                     "launches_by_path": by_path[name],
                     "launches_by_serving_route": {
                         route: counts.get(name, 0)
                         for route, counts in serving.items()},
                     "launches_per_part2_step": {
                         run_name: run["launches_per_step"][name]
                         for run_name, run in part2["runs"].items()},
                     "launches_by_gan_path": {
                         path: counts.get(name, 0)
                         for path, counts in gan["launches"].items()},
                     "launches_by_mesh_path": {
                         path: counts.get(name, 0)
                         for path, counts in mesh["launches"].items()},
                     "launches_by_eval_mode": {
                         **{mode: counts[name] for mode, counts
                            in part2["eval"]["launches"].items()},
                         **{f"visualizer {mode}":
                            run["visualizer"][0]["launches"][name]
                            for mode, run in training["runs"].items()}},
                     **{k: t[k] for k in ("timing", "plan") if k in t}})
    print(card_line(), flush=True)
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
