"""One-shot talking-face inference, neutral whole-clip path (PyTorch).

Counterpart of ``eamm_tpu/infer/pipeline.py``'s ``render`` and
``render_uint8`` with ``add_emo=False``.  A clip goes

  waveform -> MFCC windows -> ATNet -> audio keypoints (KPDetectorA) ->
  one-euro smoothing -> normalize_kp -> generator.encode_source once ->
  generator.decode per chunk of ``frame_chunk`` frames -> uint8 frames.

As in the JAX pipeline the clip length is padded up to a multiple of the
time bucket (waveform and pose with zeros; every stage before the decoder
is causal, so the padding never reaches the real frames) and the padded
tail is cut off at the end.  ``compute_dtype`` casts the generator, the
source image and the normalized keypoints; the keypoint path stays
float32.  Every decode is shared-source: the single source and its
features are never repeated per frame.
"""
from __future__ import annotations

import copy
import dataclasses
import math

import numpy as np
import torch
import torch.nn as nn

from eamm_tpu_torch import config as cfg
from eamm_tpu_torch.convert import state_dicts_from_jax
from eamm_tpu_torch.models.kp_detector import KPHead
from eamm_tpu_torch.ops.filters import one_euro_filter, one_euro_filter_np
from eamm_tpu_torch.ops.mfcc import (audio_to_mfcc_windows,
                                     min_samples_for_windows,
                                     num_windows_for_samples)
from eamm_tpu_torch.ops.motion import normalize_kp

_EMOTION_TODO = ("the emotion path is not ported yet (ROADMAP Queue 1, "
                 "'Emotion path')")
_ADAPT_SCALE_TODO = ("adapt_scale is not ported yet (ROADMAP Queue 1, "
                     "'The rest of the JAX package')")


@dataclasses.dataclass
class PipelineOptions:
    relative: bool = False            # relative keypoint movement
    audio_weight: float = 1.6         # audio feature gain of the demo
    smooth_pose: bool = True          # one-euro filter on the pose track
    frame_chunk: int = 16             # frames per generator decode
    time_bucket: int = 32             # clip-length padding granularity
    compute_dtype: torch.dtype = torch.float32   # generator decode dtype
    device: str = "cuda"


def _bucket(n: int, b: int) -> int:
    return max(b, int(math.ceil(n / b)) * b)


def prepare_pose_np(all_pose: np.ndarray, T: int,
                    smooth: bool = True) -> np.ndarray:
    """[M, 7] pose track (or [1, 7]) -> [T, 6]: a single pose is held for
    100 frames, a track is optionally one-euro smoothed, and a track
    shorter than T is extended by ping-pong tiling."""
    pose = np.asarray(all_pose, np.float32).reshape(-1, 7)[:, :6]
    if len(pose) == 1:
        pose = np.repeat(pose, 100, 0)
    elif smooth:
        pose = one_euro_filter_np(pose, mincutoff=0.004, beta=0.7, freq=100)
    if len(pose) < T:
        n = int((T - len(pose)) / len(pose) / 2) + 2
        pose = np.tile(np.concatenate([pose, pose[::-1]], axis=0), (n, 1))
    return pose[:T]


def reset_parameters(module: nn.Module, generator: torch.Generator) -> None:
    """Draw every weight of ``module`` from ``generator``: conv, linear and
    LSTM weights and biases U(+-1/sqrt(fan_in)) (the torch defaults), BN
    affine 1 and 0, BN running mean U(-0.5, 0.5) and variance U(0.5, 2)
    (random statistics, so eval BN does real work), keypoint Jacobian heads
    zero weight and identity bias (the reference initialization)."""
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d, nn.Linear)):
                bound = 1.0 / math.sqrt(m.weight[0].numel())   # fan_in
                m.weight.uniform_(-bound, bound, generator=generator)
                if m.bias is not None:
                    m.bias.uniform_(-bound, bound, generator=generator)
            elif isinstance(m, nn.LSTM):
                bound = 1.0 / math.sqrt(m.hidden_size)
                for p in m.parameters():
                    p.uniform_(-bound, bound, generator=generator)
            elif isinstance(m, nn.BatchNorm2d):
                m.weight.fill_(1.0)
                m.bias.zero_()
                m.running_mean.uniform_(-0.5, 0.5, generator=generator)
                m.running_var.uniform_(0.5, 2.0, generator=generator)
        for m in module.modules():
            if isinstance(m, KPHead):
                m.reset_jacobian()


class EammPipeline:
    """The four models on one device and the neutral clip renderer."""

    def __init__(self, config: dict, state_dicts: dict | None = None,
                 options: PipelineOptions | None = None,
                 models: dict | None = None):
        """``state_dicts``: {'generator', 'kp_detector', 'kp_detector_a',
        'audio_feature'} in the reference checkpoints' names; or ``models``
        already holding their weights, which are moved to the options'
        device (pipelines built from one ``models`` dict share it)."""
        self.config = config
        self.options = options or PipelineOptions()
        self.device = torch.device(self.options.device)
        if models is None:
            models = cfg.build_all(config)
            for name, model in models.items():
                model.load_state_dict(state_dicts[name])
        self.models = {name: m.eval().requires_grad_(False).to(self.device)
                       for name, m in models.items()}
        gen = self.models["generator"]
        if self.options.compute_dtype != torch.float32:
            gen = copy.deepcopy(gen).to(self.options.compute_dtype)
        self.generator = gen

    # ------------------------------------------------------------ stages

    @torch.no_grad()
    def clip_keypoints(self, source: torch.Tensor, windows: torch.Tensor,
                       pose: torch.Tensor):
        """source [1,3,256,256], windows [Tp,28,12], pose [Tp,6] (float32 on
        the device) -> (normalized driving kp over Tp, source kp [K,...])."""
        o, m = self.options, self.models
        kp_source = m["kp_detector"](source)
        deco = m["audio_feature"](source, windows[None], pose[None],
                                  audio_weight=o.audio_weight)[0]
        kp_audio = m["kp_detector_a"](deco)                    # over Tp
        kp_initial = {k: v[0] for k, v in kp_audio.items()}
        smoothed = {k: one_euro_filter(v, mincutoff=0.05, beta=8.0, freq=100,
                                       scale=10.0)
                    for k, v in kp_audio.items()}
        kp_s = {k: v[0] for k, v in kp_source.items()}
        kp_norm = normalize_kp(kp_s, smoothed, kp_initial,
                               use_relative_movement=o.relative,
                               use_relative_jacobian=o.relative)
        return kp_norm, kp_s

    @torch.no_grad()
    def decode_clip(self, source: torch.Tensor, kp_norm: dict,
                    kp_s: dict) -> torch.Tensor:
        """Chunked shared-source decode -> uint8 [Tp, 256, 256, 3] on the
        device."""
        dt = self.options.compute_dtype
        gen = self.generator
        src = source.to(dt)
        feats = gen.encode_source(src)
        F = self.options.frame_chunk
        Tp = kp_norm["value"].shape[0]
        frames = []
        for start in range(0, Tp, F):
            kp_d = {k: v[start:start + F].to(dt) for k, v in kp_norm.items()}
            n = kp_d["value"].shape[0]
            kp_src = {k: v.to(dt)[None].expand(n, *v.shape)
                      for k, v in kp_s.items()}
            pred = gen.decode(src, feats, kp_d, kp_src).float()
            frames.append(torch.clamp(torch.round(pred * 255.0), 0, 255)
                          .to(torch.uint8).permute(0, 2, 3, 1))
        return torch.cat(frames)

    # ------------------------------------------------------------ render

    def _prepare(self, source_image, waveform, all_pose):
        """Host-side padding: T real frames, bucketed to Tp."""
        o = self.options
        waveform = np.asarray(waveform, np.float32).reshape(-1)
        T = num_windows_for_samples(waveform.shape[0])
        Tp = _bucket(T, _bucket(o.time_bucket, o.frame_chunk))
        wav_p = np.zeros(max(waveform.shape[0], min_samples_for_windows(Tp)),
                         np.float32)
        wav_p[:waveform.shape[0]] = waveform
        pose_p = np.zeros((Tp, 6), np.float32)
        pose_p[:T] = prepare_pose_np(all_pose, T, smooth=o.smooth_pose)
        dev = self.device
        source = torch.as_tensor(np.asarray(source_image, np.float32),
                                 device=dev).permute(2, 0, 1)[None]
        return (T, source, torch.as_tensor(wav_p, device=dev),
                torch.as_tensor(pose_p, device=dev))

    @torch.no_grad()
    def render_uint8(self, source_image, waveform, all_pose,
                     transformed_video=None, add_emo: bool = False,
                     adapt_scale: bool = False) -> np.ndarray:
        """Neutral clip: source_image [256,256,3] float32 in [0, 1],
        waveform [N] float32 at 16 kHz, all_pose [M, 7] (or [1, 7]) ->
        uint8 frames [T, 256, 256, 3] on the host.  ``transformed_video``
        (the emotion frames) is read only with ``add_emo``."""
        if add_emo:
            raise NotImplementedError(_EMOTION_TODO)
        if adapt_scale:
            raise NotImplementedError(_ADAPT_SCALE_TODO)
        T, source, wav, pose = self._prepare(source_image, waveform, all_pose)
        Tp = pose.shape[0]
        windows = audio_to_mfcc_windows(wav)[:Tp]
        kp_norm, kp_s = self.clip_keypoints(source, windows, pose)
        frames = self.decode_clip(source, kp_norm, kp_s)
        return frames[:T].cpu().numpy()

    def render(self, source_image, waveform, all_pose,
               transformed_video=None, add_emo: bool = False,
               adapt_scale: bool = False) -> np.ndarray:
        """``render_uint8`` as float32 frames in [0, 1]."""
        return self.render_uint8(source_image, waveform, all_pose,
                                 transformed_video, add_emo, adapt_scale
                                 ).astype(np.float32) / 255.0

    # -------------------------------------------------------- constructors

    @classmethod
    def from_random(cls, config: dict, seed: int = 0,
                    options: PipelineOptions | None = None) -> "EammPipeline":
        """Random weights drawn on the CPU from ``torch.Generator`` seeded
        with ``seed`` (see ``reset_parameters``), then moved to the
        options' device: the same seed gives the same weights anywhere."""
        gen = torch.Generator().manual_seed(seed)
        models = cfg.build_all(config)
        for name in sorted(models):
            reset_parameters(models[name], gen)
        return cls(config, options=options, models=models)

    @classmethod
    def from_jax_variables(cls, config: dict, variables: dict,
                           options: PipelineOptions | None = None
                           ) -> "EammPipeline":
        """Weights of a JAX ``EammPipeline`` (its ``vars``, leaves as numpy
        arrays), through ``convert.state_dicts_from_jax``."""
        return cls(config, state_dicts_from_jax(variables), options)
