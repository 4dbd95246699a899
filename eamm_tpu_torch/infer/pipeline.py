"""One-shot emotional talking-face inference, whole-clip path (PyTorch).

Counterpart of ``eamm_tpu/infer/pipeline.py``'s ``render``,
``render_uint8`` and ``prepare_emotion``.  A clip goes

  waveform -> MFCC windows -> ATNet -> audio keypoints (KPDetectorA) ->
  one-euro smoothing -> (emotion displacement from the emotion frames,
  smoothed, added to keypoints 1, 4 and 6) -> normalize_kp ->
  generator.encode_source once -> generator.decode per chunk of
  ``frame_chunk`` frames -> uint8 frames.

As in the JAX pipeline ``add_emo`` defaults to True (the demo's
``linear_3`` head), the clip length is padded up to a multiple of the time
bucket (waveform and pose with zeros; every stage before the decoder is
causal, so the padding never reaches the real frames) and the padded tail
is cut off at the end.  ``compute_dtype`` casts the generator, the source
image, the normalized keypoints and, for the linear head over fewer
emotion frames than timesteps, the emotion trunk; the keypoint path, the
emotion heads and their smoothing stay float32.  Every decode is
shared-source: the single source and its features are never repeated per
frame.
"""
from __future__ import annotations

import copy
import dataclasses
import math
from typing import NamedTuple

import numpy as np
import torch
import torch.nn as nn

from eamm_tpu_torch import config as cfg
from eamm_tpu_torch.convert import state_dicts_from_jax
from eamm_tpu_torch.models import EmotionK, EmotionMap
from eamm_tpu_torch.models.kp_detector import KPHead
from eamm_tpu_torch.ops.filters import one_euro_filter, one_euro_filter_np
from eamm_tpu_torch.ops.mfcc import (audio_to_mfcc_windows,
                                     min_samples_for_windows,
                                     num_windows_for_samples)
from eamm_tpu_torch.ops.motion import normalize_kp

_STREAMING_TODO = ("yuv420 transfer and packed yuv420 emotion frames are not "
                   "ported yet (ROADMAP Queue 1 item 2, 'Delivery and "
                   "streaming')")
_ADAPT_SCALE_TODO = ("adapt_scale is not ported yet (ROADMAP Queue 1, "
                     "'The rest of the JAX package')")

# demo --type -> emotion head
_EMO_HEAD = {"linear_3": "linear", "linear_4": "linear_4",
             "linear_10": "linear_10", "linear_np_4": "linear_np_4",
             "linear_np_10": "linear_np_10", "map": "map", "map_4": "map_4"}


@dataclasses.dataclass
class PipelineOptions:
    relative: bool = False            # relative keypoint movement
    add_emo: bool = True              # emotional render unless told not to
    emo_type: str = "linear_3"        # demo --type (see _EMO_HEAD)
    audio_weight: float = 1.6         # audio feature gain of the demo
    smooth_pose: bool = True          # one-euro filter on the pose track
    frame_chunk: int = 16             # frames per generator decode
    time_bucket: int = 32             # clip-length padding granularity
    compute_dtype: torch.dtype = torch.float32   # generator decode dtype
    check_add: bool = False           # freeze the audio kp at frame 0
    transfer_format: str = "rgb"      # "rgb" only: yuv420 is not ported
    device: str = "cuda"


@dataclasses.dataclass
class EmotionHandle:
    """An emotion clip on the device, reusable across renders
    (``EammPipeline.prepare_emotion``); pass it as ``transformed_video``.

    ``frames`` [U, 3, 256, 256] float32 in [0, 1]; ``feats`` the [Ub, 512]
    float32 trunk features (linear head only, else None), Ub = U rounded
    up to a multiple of 32, rows past ``n_frames`` computed from zero
    frames and never read."""
    frames: torch.Tensor
    feats: torch.Tensor | None
    n_frames: int


class EmotionInput(NamedTuple):
    """What the emotion stage reads for one clip: ``data`` is frames
    [U, 3, H, W] or, with ``from_feats``, a trunk feature table [Ub, 512];
    ``frame_index`` [Tp] maps timestep -> row (None: row t is timestep t)."""
    data: torch.Tensor
    frame_index: torch.Tensor | None
    from_feats: bool


def _bucket(n: int, b: int) -> int:
    return max(b, int(math.ceil(n / b)) * b)


def _emotion_kind(emo_type: str) -> str:
    if emo_type not in _EMO_HEAD:
        raise ValueError(f"unknown emo_type {emo_type!r}; one of "
                         f"{sorted(_EMO_HEAD)}")
    return emo_type.split("_")[0]


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


def compose_kp(kp_audio: dict, emo: dict) -> dict:
    """Add emotion displacement rows 0, 1, 2 to keypoints 1 (x0.2), 4 and
    6; any further rows are unused."""
    out = {}
    for key in ("value", "jacobian"):
        v = kp_audio[key].clone()
        v[:, 1] += emo[key][:, 0] * 0.2
        v[:, 4] += emo[key][:, 1]
        v[:, 6] += emo[key][:, 2]
        out[key] = v
    return out


def reset_parameters(module: nn.Module, generator: torch.Generator) -> None:
    """Draw every weight of ``module`` from ``generator``: conv, linear and
    LSTM weights and biases U(+-1/sqrt(fan_in)) (the torch defaults), BN
    affine 1 and 0, BN running mean U(-0.5, 0.5) and variance U(0.5, 2)
    (random statistics, so eval BN does real work), keypoint Jacobian heads
    zero weight and identity bias (the reference initialization)."""
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, (nn.Conv1d, nn.Conv2d, nn.ConvTranspose2d,
                              nn.Linear)):
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
            if isinstance(m, (KPHead, EmotionMap)):
                m.reset_jacobian()


class EammPipeline:
    """The five models on one device and the whole-clip renderer."""

    def __init__(self, config: dict, state_dicts: dict | None = None,
                 options: PipelineOptions | None = None,
                 models: dict | None = None):
        """``state_dicts``: {'generator', 'kp_detector', 'kp_detector_a',
        'audio_feature', 'emo_detector'} in the reference checkpoints'
        names; or ``models`` already holding their weights, which are moved
        to the options' device (pipelines built from one ``models`` dict
        share it).  The emotion model is EmotionMap for a 'map*'
        ``emo_type`` and EmotionK otherwise."""
        self.config = config
        self.options = options or PipelineOptions()
        kind = _emotion_kind(self.options.emo_type)
        self.device = torch.device(self.options.device)
        if models is None:
            models = cfg.build_all(config, kind)
            for name, model in models.items():
                model.load_state_dict(state_dicts[name])
        want = EmotionMap if kind == "map" else EmotionK
        if not isinstance(models["emo_detector"], want):
            raise ValueError(f"emo_type {self.options.emo_type!r} needs "
                             f"{want.__name__}, got "
                             f"{type(models['emo_detector']).__name__}")
        self.models = {name: m.eval().requires_grad_(False).to(self.device)
                       for name, m in models.items()}
        dt = self.options.compute_dtype

        def cast(m):
            return m if dt == torch.float32 else copy.deepcopy(m).to(dt)

        self.generator = cast(self.models["generator"])
        # the trunk of the linear head's unique-frame route, whole model
        # cast (BN statistics too)
        self.emotion_trunk = (cast(self.models["emo_detector"])
                              if self._trunk_route() else None)

    def _trunk_route(self) -> bool:
        """The linear head of EmotionK can split into a trunk per unique
        frame and heads per timestep."""
        return (_EMO_HEAD[self.options.emo_type] == "linear"
                and isinstance(self.models["emo_detector"], EmotionK))

    # ------------------------------------------------------------ stages

    @torch.no_grad()
    def trunk_features(self, frames: torch.Tensor) -> torch.Tensor:
        """[U, 3, H, W] emotion frames -> [U, 512] float32 trunk features,
        computed in ``compute_dtype``."""
        dt = self.options.compute_dtype
        return self.emotion_trunk.feature(frames.to(dt)).float()

    @torch.no_grad()
    def emotion_stage(self, emotion: EmotionInput, kp_value: torch.Tensor,
                      kp_jacobian: torch.Tensor) -> dict:
        """Per-timestep emotion displacements, one-euro smoothed (x100).

        Routes, as in the JAX pipeline: a feature table is gathered and read
        by the linear head; the linear head over fewer unique frames than
        timesteps runs the trunk once per unique frame in ``compute_dtype``
        and the heads per timestep in float32; anything else runs the whole
        model per timestep in float32."""
        model = self.models["emo_detector"]
        head = _EMO_HEAD[self.options.emo_type]
        data, index = emotion.data, emotion.frame_index
        if emotion.from_feats:
            kp, _ = model.emotion_feature(data.float()[index], kp_value,
                                          kp_jacobian)
        elif index is not None and self._trunk_route():
            kp, _ = model.emotion_feature(self.trunk_features(data)[index],
                                          kp_value, kp_jacobian)
        else:
            frames = data if index is None else data[index]
            kp, _ = model(frames, kp_value, kp_jacobian, head=head)
        return {k: one_euro_filter(kp[k], mincutoff=1.0, beta=0.2, freq=100,
                                   scale=100.0)
                for k in ("value", "jacobian")}

    @torch.no_grad()
    def clip_keypoints(self, source: torch.Tensor, windows: torch.Tensor,
                       pose: torch.Tensor,
                       emotion: EmotionInput | None = None):
        """source [1,3,256,256], windows [Tp,28,12], pose [Tp,6] (float32 on
        the device), ``emotion`` for the emotional render -> (normalized
        driving kp over Tp, source kp [K,...])."""
        o, m = self.options, self.models
        kp_source = m["kp_detector"](source)
        deco = m["audio_feature"](source, windows[None], pose[None],
                                  audio_weight=o.audio_weight)[0]
        kp_audio = m["kp_detector_a"](deco)                    # over Tp
        kp_initial = {k: v[0] for k, v in kp_audio.items()}
        if o.check_add:      # only the emotion displacement animates
            driving = {k: kp_initial[k].expand_as(v)
                       for k, v in kp_audio.items()}
        else:
            driving = {k: one_euro_filter(v, mincutoff=0.05, beta=8.0,
                                          freq=100, scale=10.0)
                       for k, v in kp_audio.items()}
        if emotion is not None:
            emo = self.emotion_stage(emotion, driving["value"],
                                     driving["jacobian"])
            driving = compose_kp(driving, emo)
        kp_s = {k: v[0] for k, v in kp_source.items()}
        kp_norm = normalize_kp(kp_s, driving, kp_initial,
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

    # ------------------------------------------------------------ emotion

    def _emotion_frames(self, video) -> torch.Tensor:
        """Host emotion frames [U, H, W, 3] (float32 in [0, 1], or uint8
        scaled by float32(1/255) on the device) -> [U, 3, H, W] float32 on
        the device."""
        frames = np.asarray(video)
        if frames.dtype == np.uint8 and frames.ndim == 3:
            raise NotImplementedError(_STREAMING_TODO)
        if frames.ndim != 4 or frames.shape[-1] != 3 or not len(frames):
            raise ValueError(f"need emotion frames [U, H, W, 3], got "
                             f"{frames.shape}")
        if frames.dtype == np.uint8:
            t = torch.as_tensor(frames, device=self.device).float() \
                * np.float32(1.0 / 255.0)
        else:
            t = torch.as_tensor(frames.astype(np.float32, copy=False),
                                device=self.device)
        return t.permute(0, 3, 1, 2)

    @torch.no_grad()
    def prepare_emotion(self, transformed_video) -> EmotionHandle:
        """Upload an emotion clip once and, for the linear head, compute its
        trunk feature table (rows padded to a multiple of 32 with zero
        frames); renders given the handle skip the upload and the trunk."""
        frames = self._emotion_frames(transformed_video)
        U = frames.shape[0]
        feats = None
        if self._trunk_route():
            padded = frames.new_zeros((_bucket(U, 32), *frames.shape[1:]))
            padded[:U] = frames
            feats = self.trunk_features(padded)
        return EmotionHandle(frames=frames, feats=feats, n_frames=U)

    def _emotion_input(self, transformed_video, Tp: int) -> EmotionInput:
        """The emotion stage's input for a clip of Tp timesteps: frames cut
        to Tp, cycled by ``arange(Tp) % U`` when fewer (the demo's
        np.resize); a handle's feature table indexed with its true count."""
        if transformed_video is None:
            raise ValueError("add_emo requires transformed_video frames")
        if isinstance(transformed_video, EmotionHandle):
            handle = transformed_video
            if handle.feats is not None:
                index = torch.arange(Tp, device=self.device) % handle.n_frames
                return EmotionInput(handle.feats, index, True)
            frames = handle.frames[:Tp]
        else:
            frames = self._emotion_frames(np.asarray(transformed_video)[:Tp])
        U = frames.shape[0]
        index = torch.arange(Tp, device=self.device) % U if U < Tp else None
        return EmotionInput(frames, index, False)

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
                     transformed_video=None, add_emo: bool | None = None,
                     adapt_scale: bool = False) -> np.ndarray:
        """source_image [256,256,3] float32 in [0, 1], waveform [N] float32
        at 16 kHz, all_pose [M, 7] (or [1, 7]), transformed_video the
        mouth-masked emotion frames [U, 256, 256, 3] (float32 in [0, 1] or
        uint8) or an ``EmotionHandle``, required when ``add_emo`` (None:
        ``options.add_emo``) -> uint8 frames [T, 256, 256, 3] on the
        host."""
        o = self.options
        add_emo = o.add_emo if add_emo is None else add_emo
        if adapt_scale:
            raise NotImplementedError(_ADAPT_SCALE_TODO)
        if o.transfer_format != "rgb":
            raise NotImplementedError(_STREAMING_TODO)
        T, source, wav, pose = self._prepare(source_image, waveform, all_pose)
        Tp = pose.shape[0]
        emotion = (self._emotion_input(transformed_video, Tp) if add_emo
                   else None)
        windows = audio_to_mfcc_windows(wav)[:Tp]
        kp_norm, kp_s = self.clip_keypoints(source, windows, pose, emotion)
        frames = self.decode_clip(source, kp_norm, kp_s)
        return frames[:T].cpu().numpy()

    def render(self, source_image, waveform, all_pose,
               transformed_video=None, add_emo: bool | None = None,
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
        options' device: the same seed gives the same weights anywhere.
        The emotion model is drawn last, so the other four get the same
        weights whatever its kind."""
        options = options or PipelineOptions()
        gen = torch.Generator().manual_seed(seed)
        models = cfg.build_all(config, _emotion_kind(options.emo_type))
        for name in sorted(models, key=lambda n: (n == "emo_detector", n)):
            reset_parameters(models[name], gen)
        return cls(config, options=options, models=models)

    @classmethod
    def from_jax_variables(cls, config: dict, variables: dict,
                           options: PipelineOptions | None = None
                           ) -> "EammPipeline":
        """Weights of a JAX ``EammPipeline`` (its ``vars``, leaves as numpy
        arrays), through ``convert.state_dicts_from_jax``."""
        options = options or PipelineOptions()
        return cls(config, state_dicts_from_jax(variables, options.emo_type),
                   options)
