"""One-shot emotional talking-face inference (PyTorch).

Counterpart of ``eamm_tpu/infer/pipeline.py``'s ``render``,
``render_uint8``, ``render_yuv420``, ``render_stream``,
``render_batch_uint8``, ``render_batch_yuv420`` and ``prepare_emotion``.
A clip goes

  waveform -> MFCC windows -> ATNet -> audio keypoints (KPDetectorA) ->
  one-euro smoothing -> (emotion displacement from the emotion frames,
  smoothed, added to keypoints 1, 4 and 6) -> normalize_kp ->
  generator.encode_source once -> generator.decode per chunk of
  ``frame_chunk`` frames -> uint8 RGB frames or yuv420 planes on the host.

As in the JAX pipeline ``add_emo`` defaults to True (the demo's
``linear_3`` head).  ``compute_dtype`` casts the generator, the source
image, the normalized keypoints and, for the linear head over fewer
emotion frames than timesteps, the emotion trunk; the keypoint path, the
emotion heads and their smoothing stay float32.  Every decode is
shared-source: the sources and their features are never repeated per
frame.  Two routes serve a clip:

- **Whole clip.**  The clip is padded up to a multiple of the time bucket
  (waveform and pose with zeros; every stage before the decoder is causal,
  so the padding never reaches the real frames; the padded tail is never
  copied to the host).  The keypoint stage runs over the whole clip: its
  audio half is queued first, then the emotion frames' upload, then its
  emotion half, so the upload overlaps the audio half.  The frames decode
  in ``overlap_segments`` equal segments of whole chunks; each segment's
  copy to the host (``utils/transfer.py``) is queued behind it and runs
  while later segments decode, and the host waits for the first copy only
  once every segment is queued.  The segments decode the chunks one
  segment would, so the result does not depend on their number for a given
  padded length.
- **Unbounded** (``segment_frames``, see ``use_unbounded``).  Keypoints and
  frames in chunks of ``segment_frames`` frames, the recurrent state (the
  LSTM's, the one-euro filters', the first audio keypoints) carried from
  chunk to chunk, at most two chunks in flight: device memory does not
  grow with the clip.  Within one uint8 count of the whole clip.

``render_batch_*`` renders N neutral clips at once on the whole-clip route,
identity-major, N sources read in place by the warps.  With
``adapt_scale``, ``render_uint8`` takes the JAX pipeline's staged route: the
whole clip in one segment, the movement scaled by a convex-hull ratio the
host reads between the keypoint stage's halves, uint8 RGB out.
``from_torch_checkpoints`` loads the reference's three ``.pth.tar`` files.
``use_mesh`` spreads the batched routes over several devices (identities
in shards, one replica of the models per device) and, with
``time_shard``, each single-clip decode chunk's frames.
"""
from __future__ import annotations

import copy
import dataclasses
import math
from typing import NamedTuple

import numpy as np
import torch
import torch.nn as nn

from eamm_tpu_torch import compat
from eamm_tpu_torch import config as cfg
from eamm_tpu_torch.convert import state_dicts_from_jax
from eamm_tpu_torch.models import EmotionK, EmotionMap
from eamm_tpu_torch.models.kp_detector import KPHead
from eamm_tpu_torch.models.stylegan2 import draw_parameters
from eamm_tpu_torch.ops.colorspace import (pack_yuv420_np, rgb_to_yuv420,
                                           unpack_yuv420, yuv420_to_rgb)
from eamm_tpu_torch.ops.filters import one_euro_filter, one_euro_filter_np
from eamm_tpu_torch.ops.mfcc import (PAD_SAMPLES, audio_to_mfcc_windows,
                                     chunk_sample_start, chunk_samples_len,
                                     mfcc_window_chunk,
                                     min_samples_for_windows,
                                     num_windows_for_samples,
                                     padded_buffer_len)
from eamm_tpu_torch.ops.motion import convex_hull_area, normalize_kp
from eamm_tpu_torch.parallel.mesh import (Mesh, canonical_device,
                                          device_context, replicate_tree,
                                          split_sizes)
from eamm_tpu_torch.utils.transfer import Link

# demo --type -> emotion head
_EMO_HEAD = {"linear_3": "linear", "linear_4": "linear_4",
             "linear_10": "linear_10", "linear_np_4": "linear_np_4",
             "linear_np_10": "linear_np_10", "map": "map", "map_4": "map_4"}
_TRANSFER_FORMATS = ("rgb", "yuv420")


@dataclasses.dataclass
class PipelineOptions:
    relative: bool = False            # relative keypoint movement
    # render_uint8 takes the staged route: the movement scaled by the
    # convex-hull ratio of the source and the first audio keypoints, read
    # on the host (it moves the frames only with ``relative``)
    adapt_scale: bool = False
    add_emo: bool = True              # emotional render unless told not to
    emo_type: str = "linear_3"        # demo --type (see _EMO_HEAD)
    audio_weight: float = 1.6         # audio feature gain of the demo
    smooth_pose: bool = True          # one-euro filter on the pose track
    frame_chunk: int = 16             # frames per generator decode
    time_bucket: int = 32             # clip-length padding granularity
    compute_dtype: torch.dtype = torch.float32   # generator decode dtype
    check_add: bool = False           # freeze the audio kp at frame 0
    # "rgb": uint8 RGB frames to the host.  "yuv420": yuv420p planes made
    # on the device from each chunk's float prediction, 12 bits a pixel
    # (the loss a yuv420p encoder imposes), and float emotion frames
    # uploaded as packed planes
    transfer_format: str = "rgb"
    # the JAX package's concurrent copies to the host; accepted so that
    # its options carry over, and ignored: each payload tensor goes to
    # the host in one copy on the link's copy stream
    fetch_streams: int = 6
    # whole-clip renders decode in this many equal segments, each copied to
    # the host while the later ones decode (1: one segment)
    overlap_segments: int = 1
    # unbounded streaming: chunks of this many frames (a multiple of
    # frame_chunk), the recurrent state carried between them
    segment_frames: int | None = None
    # with segment_frames, clips of at most this many frames keep the whole
    # clip route and longer ones take the chunks; without a policy every
    # render takes the chunks (render_uint8 and render_yuv420 too)
    stream_policy_frames: int | None = None
    device: str = "cuda"


@dataclasses.dataclass
class EmotionHandle:
    """An emotion clip on the device, reusable across renders
    (``EammPipeline.prepare_emotion``); pass it as ``transformed_video``.

    ``frames`` [U, 3, 256, 256] float32 in [0, 1] (on a yuv420 pipeline
    uploaded as packed planes and unpacked on the device); ``feats`` the
    [Ub, 512] float32 trunk features (linear head only, else None), Ub = U
    rounded up to a multiple of 32, rows past ``n_frames`` computed from
    zero frames and never read."""
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


def upload_sources(images, device) -> torch.Tensor:
    """Source images [..., 256, 256, 3] -> float32 [N, 256, 256, 3] on
    ``device``, from a fresh C-ordered copy: the strides, a lone image's
    batch stride too, pick the convolutions' kernels, so the live routes and
    the exported programs (``infer/export.py``) upload sources alike."""
    return torch.as_tensor(np.array(images, np.float32).reshape(
        -1, 256, 256, 3), device=device)


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
    zero weight and identity bias (the reference initialization), StyleGAN2
    layers as the JAX package draws them (``stylegan2.draw_parameters``)."""
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
        draw_parameters(module, generator)
        for m in module.modules():
            if isinstance(m, (KPHead, EmotionMap)):
                m.reset_jacobian()


_EURO_PARTS = ("raw", "filtered", "derivative", "started")


def carry_names(emotional: bool) -> list[str]:
    """The unbounded chunks' carry as flat tensors, in order: the LSTM's
    (h, c), the audio filters' states, the first audio keypoints and, when
    emotional, the emotion filters' states."""
    def euro(group):
        return [f"{group}.{k}.{p}" for k in ("value", "jacobian")
                for p in _EURO_PARTS]
    return (["lstm_h", "lstm_c", *euro("euro"), "kp_initial.value",
             "kp_initial.jacobian"] + (euro("emo_euro") if emotional else []))


def flatten_carry(carry: dict, emotional: bool) -> tuple:
    """``_stream_kp_chunk``'s carry -> tensors in ``carry_names`` order."""
    out = [*carry["lstm"]]
    out += [t for k in ("value", "jacobian") for t in carry["euro"][k]]
    out += [carry["kp_initial"][k] for k in ("value", "jacobian")]
    if emotional:
        out += [t for k in ("value", "jacobian") for t in carry["emo_euro"][k]]
    return tuple(out)


def unflatten_carry(flat, emotional: bool) -> dict:
    """``flatten_carry``'s inverse."""
    flat = list(flat)
    if len(flat) != len(carry_names(emotional)):
        raise ValueError(f"need {len(carry_names(emotional))} carry tensors, "
                         f"got {len(flat)}")

    def euro(parts):
        return {"value": tuple(parts[:4]), "jacobian": tuple(parts[4:8])}

    carry = {"lstm": (flat[0], flat[1]), "euro": euro(flat[2:10]),
             "kp_initial": {"value": flat[10], "jacobian": flat[11]}}
    if emotional:
        carry["emo_euro"] = euro(flat[12:20])
    return carry


class EammPipeline:
    """The five models on one device and the renderers."""

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
        if self.options.transfer_format not in _TRANSFER_FORMATS:
            raise ValueError(f"transfer_format must be one of "
                             f"{_TRANSFER_FORMATS}, got "
                             f"{self.options.transfer_format!r}")
        self.device = torch.device(self.options.device)
        self.link = Link(self.device)        # copies to and from the host
        self.mesh: Mesh | None = None        # set by use_mesh
        self.time_shard = False
        self._replicas: list = []            # one pipeline per mesh device
        self.last_movement_scale: float | None = None   # adapt_scale's
        self.ignored_keys: dict = {}     # from_torch_checkpoints' skipped
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

    @property
    def _yuv(self) -> bool:
        return self.options.transfer_format == "yuv420"

    # ------------------------------------------------------------ stages

    @torch.no_grad()
    def trunk_features(self, frames: torch.Tensor) -> torch.Tensor:
        """[U, 3, H, W] emotion frames -> [U, 512] float32 trunk features,
        computed in ``compute_dtype``."""
        dt = self.options.compute_dtype
        return self.emotion_trunk.feature(frames.to(dt)).float()

    @torch.no_grad()
    def emotion_stage(self, emotion: EmotionInput, kp_value: torch.Tensor,
                      kp_jacobian: torch.Tensor, euro_carry: dict | None = None,
                      return_carry: bool = False):
        """Per-timestep emotion displacements, one-euro smoothed (x100),
        the filters started from ``euro_carry`` ({'value', 'jacobian'}
        states; None: fresh); with ``return_carry`` their final states too.

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
        smoothed, carry = {}, {}
        for k in ("value", "jacobian"):
            smoothed[k], carry[k] = one_euro_filter(
                kp[k], mincutoff=1.0, beta=0.2, freq=100, scale=100.0,
                carry=None if euro_carry is None else euro_carry[k],
                return_carry=True)
        return (smoothed, carry) if return_carry else smoothed

    def _smooth_audio(self, kp_audio: dict, kp_initial: dict,
                      carry: dict | None = None):
        """Audio keypoints -> (driving keypoints, the filters' states): the
        one-euro filter from ``carry``, or with ``check_add`` the first
        audio keypoints held (only the emotion displacement animates)."""
        if self.options.check_add:
            return ({k: kp_initial[k].expand_as(v)
                     for k, v in kp_audio.items()}, carry)
        driving, states = {}, {}
        for k, v in kp_audio.items():
            driving[k], states[k] = one_euro_filter(
                v, mincutoff=0.05, beta=8.0, freq=100, scale=10.0,
                carry=None if carry is None else carry[k], return_carry=True)
        return driving, states

    @torch.no_grad()
    def audio_keypoints(self, source: torch.Tensor, windows: torch.Tensor,
                        pose: torch.Tensor):
        """The audio half of the keypoint stage: source [1,3,256,256],
        windows [Tp,28,12], pose [Tp,6] (float32 on the device) -> (source
        kp [K,...], smoothed driving kp over Tp, the first audio kp
        unsmoothed)."""
        o, m = self.options, self.models
        kp_source = m["kp_detector"](source)
        deco = m["audio_feature"](source, windows[None], pose[None],
                                  audio_weight=o.audio_weight)[0]
        kp_audio = m["kp_detector_a"](deco)                    # over Tp
        kp_initial = {k: v[0] for k, v in kp_audio.items()}
        driving, _ = self._smooth_audio(kp_audio, kp_initial)
        return {k: v[0] for k, v in kp_source.items()}, driving, kp_initial

    @torch.no_grad()
    def emotion_keypoints(self, kp_s: dict, driving: dict, kp_initial: dict,
                          emotion: EmotionInput | None = None,
                          euro_carry: dict | None = None,
                          return_carry: bool = False, scale: float = 1.0):
        """The emotion half: the emotion displacement, when ``emotion`` is
        given, added to the driving keypoints, then ``normalize_kp`` with
        movement scale ``scale`` -> normalized driving kp (and the emotion
        filters' states with ``return_carry``)."""
        o = self.options
        if emotion is not None:
            emo, euro_carry = self.emotion_stage(
                emotion, driving["value"], driving["jacobian"], euro_carry,
                return_carry=True)
            driving = compose_kp(driving, emo)
        kp_norm = normalize_kp(kp_s, driving, kp_initial,
                               use_relative_movement=o.relative,
                               use_relative_jacobian=o.relative,
                               adapt_movement_scale=scale)
        return (kp_norm, euro_carry) if return_carry else kp_norm

    def clip_keypoints(self, source: torch.Tensor, windows: torch.Tensor,
                       pose: torch.Tensor,
                       emotion: EmotionInput | None = None):
        """Both halves over the whole clip -> (normalized driving kp over
        Tp, source kp [K,...])."""
        kp_s, driving, kp_initial = self.audio_keypoints(source, windows, pose)
        return self.emotion_keypoints(kp_s, driving, kp_initial, emotion), kp_s

    @torch.no_grad()
    def source_features(self, source: torch.Tensor):
        """Sources [Bs, 3, 256, 256] -> (in ``compute_dtype``, encoded)."""
        src = source.to(self.options.compute_dtype)
        return src, self.generator.encode_source(src)

    def _to_payload(self, pred: torch.Tensor, rgb: bool = False) -> tuple:
        """Float prediction [n, 3, H, W] in [0, 1] -> (uint8 frames
        [n, H, W, 3],) or, on a yuv420 pipeline unless ``rgb``, (Y, U, V)
        uint8 planes."""
        nhwc = pred.float().permute(0, 2, 3, 1)
        if self._yuv and not rgb:
            return rgb_to_yuv420(nhwc)
        return (torch.clamp(torch.round(nhwc * 255.0), 0, 255)
                .to(torch.uint8),)

    @torch.no_grad()
    def decode_frames(self, src: torch.Tensor, feats: torch.Tensor,
                      kp_driving: dict, kp_source: dict, start: int,
                      stop: int, chunk: int, rgb: bool = False,
                      shard_time: bool = False) -> tuple:
        """Frames [start, stop) of N identities (sources and features from
        ``source_features``, driving kp [N, Tp, ...], source kp [N, ...]),
        in chunks of ``chunk`` frames an identity, identity-major: N x chunk
        frames a decode, frame b reading source b // chunk in place -> the
        payload (``_to_payload``, uint8 RGB with ``rgb``), each tensor
        [N, stop - start, ...], on the device.  With ``shard_time`` (one
        identity) on a ``use_mesh(time_shard=True)`` pipeline each chunk's
        frames are split over the mesh (``_decode_sharded``)."""
        dt = self.options.compute_dtype
        N = src.shape[0]
        kp_src = {k: v.to(dt) for k, v in kp_source.items()}
        parts = []
        for t in range(start, stop, chunk):
            kp_d = {k: v[:, t:min(t + chunk, stop)].to(dt)
                    for k, v in kp_driving.items()}
            n = kp_d["value"].shape[1]
            kp_d = {k: v.flatten(0, 1) for k, v in kp_d.items()}
            kps = {k: v.repeat_interleave(n, dim=0) for k, v in kp_src.items()}
            if shard_time and self.time_shard and N == 1:
                out = self._decode_sharded(src, feats, kp_d, kps, rgb)
            else:
                out = self._to_payload(
                    self.generator.decode(src, feats, kp_d, kps), rgb)
            parts.append(tuple(x.view(N, n, *x.shape[1:]) for x in out))
        return tuple(torch.cat(p, dim=1) for p in zip(*parts))

    def _decode_sharded(self, src: torch.Tensor, feats: torch.Tensor,
                        kp_d: dict, kps: dict, rgb: bool) -> tuple:
        """One identity's decode chunk with its frames in contiguous parts,
        one per mesh device, each decoded and made a payload by that
        device's replica (the source and its features copied there), the
        parts joined on this pipeline's device in frame order."""
        n = kp_d["value"].shape[0]
        parts, start = [], 0
        for rep, k in zip(self._replicas, split_sizes(n, len(self._replicas))):
            if k == 0:
                continue
            d = rep.device
            with device_context(d):
                out = rep._to_payload(rep.generator.decode(
                    src.to(d), feats.to(d),
                    {key: v[start:start + k].to(d) for key, v in kp_d.items()},
                    {key: v[start:start + k].to(d) for key, v in kps.items()}),
                    rgb)
            parts.append(tuple(x.to(self.device) for x in out))
            start += k
        return tuple(torch.cat(p) for p in zip(*parts))

    def _decode_one(self, src: torch.Tensor, feats: torch.Tensor,
                    kp_norm: dict, kp_s: dict, start: int,
                    stop: int) -> tuple:
        """``decode_frames`` of one identity in chunks of ``frame_chunk``:
        kp_norm over the clip, kp_s [K, ...] -> each payload tensor
        [stop - start, ...]."""
        payload = self.decode_frames(
            src, feats, {k: v[None] for k, v in kp_norm.items()},
            {k: v[None] for k, v in kp_s.items()}, start, stop,
            self.options.frame_chunk, shard_time=True)
        return tuple(x[0] for x in payload)

    def decode_clip(self, source: torch.Tensor, kp_norm: dict, kp_s: dict):
        """Chunked shared-source decode of the whole clip -> on the device,
        uint8 [Tp, 256, 256, 3], or (Y, U, V) on a yuv420 pipeline."""
        payload = self._decode_one(*self.source_features(source), kp_norm,
                                   kp_s, 0, kp_norm["value"].shape[0])
        return payload if self._yuv else payload[0]

    # ------------------------------------------------------------ emotion

    def _upload_emotion(self, video) -> torch.Tensor:
        """Host emotion frames -> the device as they travel: float32
        [U, H, W, 3] in [0, 1], uint8 [U, H, W, 3], or packed yuv420 planes
        uint8 [U, 3H/2, W] (``pack_yuv420_np``; a yuv420 pipeline packs
        float frames on the host first)."""
        frames = np.asarray(video)
        packed = frames.dtype == np.uint8 and frames.ndim == 3
        if not (packed or (frames.ndim == 4 and frames.shape[-1] == 3)) \
                or not len(frames):
            raise ValueError(f"need emotion frames [U, H, W, 3] or packed "
                             f"yuv420 planes [U, 3H/2, W] uint8, got "
                             f"{frames.shape} {frames.dtype}")
        if frames.dtype != np.uint8:
            frames = frames.astype(np.float32, copy=False)
            if self._yuv:
                frames = pack_yuv420_np(frames)
        return self.link.upload(frames)

    @staticmethod
    def _decode_emotion(frames: torch.Tensor) -> torch.Tensor:
        """Uploaded emotion frames -> [U, 3, H, W] float32 in [0, 1]:
        packed planes unpacked, uint8 RGB scaled by float32(1/255)."""
        if frames.dtype == torch.uint8:
            frames = (unpack_yuv420(frames) if frames.dim() == 3
                      else frames.float() * np.float32(1.0 / 255.0))
        return frames.permute(0, 3, 1, 2)

    def _emotion_frames(self, video) -> torch.Tensor:
        """Host emotion frames (``_upload_emotion``) -> [U, 3, H, W] float32
        on the device."""
        return self._decode_emotion(self._upload_emotion(video))

    @torch.no_grad()
    def prepare_emotion(self, transformed_video) -> EmotionHandle:
        """Upload an emotion clip once and, for the linear head, compute its
        trunk feature table (rows padded to a multiple of 32 with zero
        frames); renders given the handle skip the upload and the trunk."""
        frames = self._emotion_frames(transformed_video)
        feats = self.emotion_table(frames) if self._trunk_route() else None
        return EmotionHandle(frames=frames, feats=feats, n_frames=len(frames))

    @torch.no_grad()
    def emotion_table(self, frames: torch.Tensor) -> torch.Tensor:
        """Emotion frames [U, 3, H, W] -> the trunk feature table [Ub, 512]
        of a handle: the frames zero-padded to Ub, U rounded up to a
        multiple of 32."""
        U = frames.shape[0]
        padded = frames.new_zeros((_bucket(U, 32), *frames.shape[1:]))
        padded[:U] = frames
        return self.trunk_features(padded)

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

    # ------------------------------------------------- whole-clip route

    def _source_tensor(self, source_image) -> torch.Tensor:
        """[256, 256, 3] -> [1, 3, 256, 256], a view of ``upload_sources``'s
        [1, 256, 256, 3]."""
        return upload_sources(source_image, self.device).permute(0, 3, 1, 2)

    def _prepare(self, source_image, waveform, all_pose, segments: int = 1):
        """Host-side padding: T real frames, bucketed to Tp, which splits
        into ``segments`` equal segments of whole decode chunks."""
        o = self.options
        waveform = np.asarray(waveform, np.float32).reshape(-1)
        T = num_windows_for_samples(waveform.shape[0])
        Tp = _bucket(T, _bucket(o.time_bucket, o.frame_chunk * segments))
        wav_p = np.zeros(max(waveform.shape[0], min_samples_for_windows(Tp)),
                         np.float32)
        wav_p[:waveform.shape[0]] = waveform
        pose_p = np.zeros((Tp, 6), np.float32)
        pose_p[:T] = prepare_pose_np(all_pose, T, smooth=o.smooth_pose)
        dev = self.device
        return (T, self._source_tensor(source_image),
                torch.as_tensor(wav_p, device=dev),
                torch.as_tensor(pose_p, device=dev))

    def _kp_stage(self, source, wav, pose, transformed_video, add_emo,
                  adapt_scale: bool = False):
        """The whole clip's keypoint stage: the audio half is queued first,
        then the emotion frames' upload, then the emotion half, so a cold
        render's upload overlaps the audio half; with ``adapt_scale`` the
        host reads the keypoints for ``movement_scale`` in between.  ->
        (normalized driving kp over Tp, source kp)."""
        if add_emo and transformed_video is None:
            raise ValueError("add_emo requires transformed_video frames")
        Tp = pose.shape[0]
        kp_s, driving, kp_initial = self.audio_keypoints(
            source, audio_to_mfcc_windows(wav)[:Tp], pose)
        scale = 1.0
        if adapt_scale:
            scale = self.last_movement_scale = self.movement_scale(
                kp_s, kp_initial)
        emotion = (self._emotion_input(transformed_video, Tp) if add_emo
                   else None)
        return self.emotion_keypoints(kp_s, driving, kp_initial, emotion,
                                      scale=scale), kp_s

    @staticmethod
    def movement_scale(kp_source: dict, kp_initial: dict) -> float:
        """sqrt(area) of the source keypoints' convex hull over sqrt(area)
        of the first audio keypoints' (each {'value': [K, 2], ...}), on the
        host: ``adapt_scale``'s movement scale."""
        src = convex_hull_area(kp_source["value"].float().cpu().numpy())
        drv = convex_hull_area(kp_initial["value"].float().cpu().numpy())
        return float(np.sqrt(src) / np.sqrt(drv))

    def _queue_segments(self, T: int, Tseg: int, decode,
                        axis: int = 0) -> list:
        """[(start frame, its copy to the host in flight)] per segment of
        Tseg frames, in clip order, ``decode(start, stop)`` giving a
        segment's payload on the device: every segment's decode and copy
        queued, nothing waited for.  Each copy is cut to the T real frames
        along ``axis``; segments holding only padding are not decoded."""
        return [(start, self.link.fetch_async(
            decode(start, start + Tseg), min(Tseg, T - start), axis))
            for start in range(0, T, Tseg)]

    def _segments(self, T: int, Tseg: int, decode, axis: int = 0):
        """Yields (start frame, payload on the host) per segment of
        ``_queue_segments``, the host waiting for the first copy only once
        every segment is queued."""
        for start, fetch in self._queue_segments(T, Tseg, decode, axis):
            yield start, fetch.result()

    @torch.no_grad()
    def _render_segments(self, source_image, waveform, all_pose,
                         transformed_video, add_emo):
        """The whole-clip route: yields (start frame, payload on the host)
        per segment of the clip (``_segments``)."""
        S = max(1, self.options.overlap_segments)
        T, source, wav, pose = self._prepare(source_image, waveform,
                                             all_pose, S)
        kp_norm, kp_s = self._kp_stage(source, wav, pose, transformed_video,
                                       add_emo)
        _, feats = self.source_features(source)
        kv, kj = kp_norm["value"], kp_norm["jacobian"]
        nhwc = source.permute(0, 2, 3, 1)
        yield from self._segments(T, pose.shape[0] // S, lambda a, b: (
            self._render_segment_impl(nhwc, feats, kp_s["value"],
                                      kp_s["jacobian"], kv[a:b], kj[a:b])))

    @torch.no_grad()
    def _render_staged(self, source_image, waveform, all_pose,
                       transformed_video, add_emo) -> np.ndarray:
        """The adapt_scale route of ``render_uint8``: the whole-clip route
        in one segment with the movement scale (``_kp_stage``), whatever
        the clip's length, decoded as uint8 RGB whatever the transfer
        format, as in the JAX pipeline -> uint8 [T, 256, 256, 3]."""
        T, source, wav, pose = self._prepare(source_image, waveform,
                                             all_pose)
        kp_norm, kp_s = self._kp_stage(source, wav, pose, transformed_video,
                                       add_emo, adapt_scale=True)
        src, feats = self.source_features(source)
        frames = self.decode_frames(
            src, feats, {k: v[None] for k, v in kp_norm.items()},
            {k: v[None] for k, v in kp_s.items()}, 0, pose.shape[0],
            self.options.frame_chunk, rgb=True, shard_time=True)[0][0]
        return self.link.fetch_async((frames,), T).result()[0]

    # ------------------------------------------------- unbounded route

    def use_unbounded(self, frames: int) -> bool:
        """Should a clip of ``frames`` delivered frames take the unbounded
        chunks (True) or the whole-clip route?  Never without
        ``segment_frames``; always with it and no
        ``stream_policy_frames``; else past the policy's length."""
        o = self.options
        if not o.segment_frames:
            return False
        if o.stream_policy_frames is None:
            return True
        return frames > o.stream_policy_frames

    @torch.no_grad()
    def _stream_prelude_impl(self, source: torch.Tensor) -> tuple:
        """Once a stream: source [1, 256, 256, 3] -> (source kp value
        [K, 2], jacobian [K, 2, 2], ATNet's identity feature [1, 512], the
        encoded source features)."""
        m = self.models
        src = source.permute(0, 3, 1, 2)
        kp_s = m["kp_detector"](src)
        image_feature = m["audio_feature"].encode_image(src)
        _, feats = self.source_features(src)
        return (kp_s["value"][0], kp_s["jacobian"][0], image_feature, feats)

    @torch.no_grad()
    def _stream_kp_chunk(self, kp_s: dict, image_feature: torch.Tensor,
                         samples: torch.Tensor, pose: torch.Tensor,
                         emotion: EmotionInput | None, carry: dict | None):
        """One chunk's keypoints: ``samples`` the sample before the
        chunk's slice of the padded buffer, then the slice
        [chunk_samples_len(K)]; pose [K, 6] -> (normalized kp over K, the
        carry: the LSTM's (h, c), the audio and emotion filters' states and
        the first chunk's first audio kp, unsmoothed).  ``carry`` None
        starts the stream."""
        o, m = self.options, self.models
        K = pose.shape[0]
        carry = carry or {}
        windows = mfcc_window_chunk(samples[1:], samples[:1], K)
        deco, lstm = m["audio_feature"].window_features(
            image_feature, windows[None], pose[None], o.audio_weight,
            carry=carry.get("lstm"), return_carry=True)
        kp_audio = m["kp_detector_a"](deco[0])
        kp_initial = carry.get("kp_initial") or {
            k: v[0] for k, v in kp_audio.items()}
        driving, euro = self._smooth_audio(kp_audio, kp_initial,
                                           carry.get("euro"))
        kp_norm, emo_euro = self.emotion_keypoints(
            kp_s, driving, kp_initial, emotion, carry.get("emo_euro"),
            return_carry=True)
        return kp_norm, {"lstm": lstm, "euro": euro,
                         "kp_initial": kp_initial, "emo_euro": emo_euro}

    @torch.no_grad()
    def _render_stream_unbounded(self, source_image, waveform, all_pose,
                                 transformed_video, add_emo):
        """The unbounded route: yields (start frame, payload on the host)
        per chunk of ``segment_frames``.  One zero-padded host sample
        buffer, each chunk's slice uploaded with the sample before it;
        emotion frames made a handle once; a chunk's decode and copy are
        queued before the host waits for the chunk two back, so at most two
        are in flight."""
        o = self.options
        K = o.segment_frames
        if K % o.frame_chunk:
            raise ValueError("segment_frames must be a multiple of "
                             "frame_chunk")
        wav = np.asarray(waveform, np.float32).reshape(-1)
        T = num_windows_for_samples(wav.shape[0])
        n_chunks = max(1, math.ceil(T / K))
        # buf[1 + i] is sample i of the padded signal; buf[0] is a zero
        # before it, the first chunk's preceding sample
        buf = np.zeros(1 + max(padded_buffer_len(n_chunks * K),
                               2 * PAD_SAMPLES + wav.shape[0]), np.float32)
        buf[1 + PAD_SAMPLES:1 + PAD_SAMPLES + wav.shape[0]] = wav
        pose = np.zeros((n_chunks * K, 6), np.float32)
        pose[:T] = prepare_pose_np(all_pose, T, smooth=o.smooth_pose)
        handle = None
        if add_emo:
            if transformed_video is None:
                raise ValueError("add_emo requires transformed_video frames")
            handle = (transformed_video
                      if isinstance(transformed_video, EmotionHandle)
                      else self.prepare_emotion(transformed_video))
        source = upload_sources(source_image, self.device)
        ksv, ksj, image_feature, feats = self._stream_prelude_impl(source)
        kp_s = {"value": ksv, "jacobian": ksj}
        n_samples = 1 + chunk_samples_len(K)
        carry, pending = None, []
        for c in range(n_chunks):
            s0 = chunk_sample_start(c * K)
            emotion = None
            if handle is not None:
                index = (torch.arange(c * K, (c + 1) * K, device=self.device)
                         % handle.n_frames)
                emotion = (EmotionInput(handle.feats, index, True)
                           if handle.feats is not None
                           else EmotionInput(handle.frames, index, False))
            if len(pending) == 2:
                start, fetch = pending.pop(0)
                yield start, fetch.result()
            kp_norm, carry = self._stream_kp_chunk(
                kp_s, image_feature,
                self.link.upload(buf[s0:s0 + n_samples]),
                self.link.upload(pose[c * K:(c + 1) * K]),
                emotion, carry)
            payload = self._render_segment_impl(
                source, feats, ksv, ksj, kp_norm["value"],
                kp_norm["jacobian"])
            pending.append((c * K, self.link.fetch_async(
                payload, min(K, T - c * K))))
        for start, fetch in pending:
            yield start, fetch.result()

    # ------------------------------------------------- the mesh

    def use_mesh(self, mesh, time_shard: bool = False) -> "EammPipeline":
        """Spread the renders over ``mesh`` (a ``parallel.Mesh`` or a list
        of devices) and return self, as JAX's ``use_mesh`` does.  The
        batched routes split the identities into contiguous shards, one per
        device, each rendered by that device's replica of the models (this
        pipeline itself on its own device, a copy of its models elsewhere),
        the payloads joined in identity order.  With ``time_shard`` the
        single-clip routes (whole clip, segments, unbounded chunks, staged)
        also split each decode chunk's frames over the devices;
        ``frame_chunk`` must be a multiple of the mesh's size.  The port's
        kernels run on each device and stay on (JAX turns its Pallas warp
        off here, since ``shard_map`` does not wrap it).  The keypoint
        stage runs on this pipeline's device."""
        mesh = mesh if isinstance(mesh, Mesh) else Mesh(tuple(mesh))
        if time_shard and self.options.frame_chunk % mesh.size:
            raise ValueError(f"time_shard: frame_chunk "
                             f"{self.options.frame_chunk} is not a multiple "
                             f"of the mesh's {mesh.size} devices")
        replicas = {canonical_device(self.device): self}
        for d in mesh.devices:
            if d not in replicas:
                replicas[d] = EammPipeline(
                    self.config, options=dataclasses.replace(
                        self.options, device=str(d)),
                    models=replicate_tree(self.models, Mesh((d,)))[0])
        self.mesh, self.time_shard = mesh, time_shard
        self._replicas = [replicas[d] for d in mesh.devices]
        return self

    # ------------------------------------------------- entry points

    def audio_to_windows(self, waveform: np.ndarray) -> np.ndarray:
        """[S] float32 waveform at 16 kHz -> MFCC windows [T, 28, 12]
        float32 on the host (JAX's ``audio_to_windows``)."""
        wav = torch.as_tensor(np.asarray(waveform, np.float32).reshape(-1),
                              device=self.device)
        return audio_to_mfcc_windows(wav).cpu().numpy()

    def prepare_pose(self, all_pose: np.ndarray, T: int) -> np.ndarray:
        """Host-side pose tiling and smoothing, [M, 7] -> [T, 6]
        (``prepare_pose_np`` with ``options.smooth_pose``)."""
        return prepare_pose_np(all_pose, T, smooth=self.options.smooth_pose)

    def _payloads(self, source_image, waveform, all_pose, transformed_video,
                  add_emo):
        """(start frame, payload) of the clip in order, by the route
        ``use_unbounded`` picks for its length."""
        add_emo = self.options.add_emo if add_emo is None else add_emo
        T = num_windows_for_samples(np.asarray(waveform).reshape(-1).shape[0])
        route = (self._render_stream_unbounded if self.use_unbounded(T)
                 else self._render_segments)
        return route(source_image, waveform, all_pose, transformed_video,
                     add_emo)

    @staticmethod
    def _join(payloads, axis: int = 0) -> tuple:
        parts = [p for _, p in payloads]
        if len(parts) == 1:
            return parts[0]
        return tuple(np.concatenate(x, axis=axis) for x in zip(*parts))

    def render_uint8(self, source_image, waveform, all_pose,
                     transformed_video=None,
                     add_emo: bool | None = None) -> np.ndarray:
        """source_image [256,256,3] float32 in [0, 1], waveform [N] float32
        at 16 kHz, all_pose [M, 7] (or [1, 7]), transformed_video the
        mouth-masked emotion frames [U, 256, 256, 3] (float32 in [0, 1] or
        uint8), packed yuv420 planes [U, 384, 256] uint8, or an
        ``EmotionHandle``, required when ``add_emo`` (None:
        ``options.add_emo``) -> uint8 frames [T, 256, 256, 3] on the host
        (on a yuv420 pipeline ``render_yuv420`` turned back into RGB; with
        ``options.adapt_scale`` the staged route, ``_render_staged``, its
        scale kept in ``last_movement_scale``)."""
        if self.options.adapt_scale:
            add_emo = self.options.add_emo if add_emo is None else add_emo
            return self._render_staged(source_image, waveform, all_pose,
                                       transformed_video, add_emo)
        if self._yuv:
            return yuv420_to_rgb(*self.render_yuv420(
                source_image, waveform, all_pose, transformed_video, add_emo))
        return self._join(self._payloads(source_image, waveform, all_pose,
                                         transformed_video, add_emo))[0]

    def render_yuv420(self, source_image, waveform, all_pose,
                      transformed_video=None, add_emo: bool | None = None):
        """``render_uint8``'s clip as yuv420p planes: (Y [T,256,256], U, V
        [T,128,128]) uint8 on the host.  Needs transfer_format 'yuv420'."""
        if not self._yuv:
            raise ValueError("render_yuv420 requires transfer_format='yuv420'")
        return self._join(self._payloads(source_image, waveform, all_pose,
                                         transformed_video, add_emo))

    def render_stream(self, source_image, waveform, all_pose,
                      transformed_video=None, add_emo: bool | None = None):
        """A generator of (start frame, payload) in clip order: payload the
        uint8 frames [k, 256, 256, 3] or, on a yuv420 pipeline, the (Y, U, V)
        planes of frames start .. start + k - 1.  Whole-clip route: one
        payload per segment (``overlap_segments``), each as soon as its copy
        is done; unbounded route: one per chunk.  The payloads put together
        equal ``render_uint8`` / ``render_yuv420``.  Refuses
        ``options.adapt_scale``, as the JAX pipeline does."""
        if self.options.adapt_scale:
            raise ValueError("render_stream does not support adapt_scale "
                             "(its convex-hull scale is a host round trip)")
        for start, payload in self._payloads(source_image, waveform, all_pose,
                                             transformed_video, add_emo):
            yield start, (payload if self._yuv else payload[0])

    def render(self, source_image, waveform, all_pose,
               transformed_video=None,
               add_emo: bool | None = None) -> np.ndarray:
        """``render_uint8`` as float32 frames in [0, 1]."""
        return self.render_uint8(source_image, waveform, all_pose,
                                 transformed_video, add_emo
                                 ).astype(np.float32) / 255.0

    # ------------------------------------------------- batched render

    def _batch_chunk(self, n_identities: int) -> int:
        """Frames per identity in a batched decode: N x F stays at most 128
        (F at least 8), so activations do not grow with N."""
        return max(8, min(self.options.frame_chunk,
                          128 // max(1, n_identities)))

    def _prepare_batch(self, source_images, waveforms, poses,
                       T: int = 0, chunk: int | None = None):
        """Host-side padding for N clips: each clip's MFCC windows computed
        from its own waveform, then windows and poses zero-padded to the
        longest clip (at least ``T`` frames: a mesh shard pads to the whole
        batch's), bucketed so the padded length splits into
        ``overlap_segments`` segments of whole batch chunks (of ``chunk``
        frames, by default ``_batch_chunk(N)``)."""
        o, dev = self.options, self.device
        N = len(waveforms)
        windows = [audio_to_mfcc_windows(torch.as_tensor(
            np.asarray(w, np.float32).reshape(-1), device=dev))
            for w in waveforms]
        T = max(T, *(w.shape[0] for w in windows))
        S = max(1, o.overlap_segments)
        chunk = chunk or self._batch_chunk(N)
        Tp = _bucket(T, _bucket(o.time_bucket, chunk * S))
        win = windows[0].new_zeros((N, Tp, *windows[0].shape[1:]))
        pose = np.zeros((N, Tp, 6), np.float32)
        for i, w in enumerate(windows):
            win[i, :w.shape[0]] = w
            pose[i, :w.shape[0]] = prepare_pose_np(poses[i], w.shape[0],
                                                   smooth=o.smooth_pose)
        sources = upload_sources(source_images, dev).permute(0, 3, 1, 2)
        return T, sources, win, torch.as_tensor(pose, device=dev)

    @torch.no_grad()
    def batch_keypoints(self, sources: torch.Tensor, windows: torch.Tensor,
                        pose: torch.Tensor):
        """N neutral clips at once: sources [N,3,256,256], windows
        [N,Tp,28,12], pose [N,Tp,6] -> (driving kp [N, Tp, ...], one-euro
        smoothed per identity along time, source kp [N, ...]).  As in the
        JAX pipeline's batch, the keypoints are not normalized."""
        o, m = self.options, self.models
        N, Tp = windows.shape[:2]
        kp_source = m["kp_detector"](sources)
        deco = m["audio_feature"](sources, windows, pose,
                                  audio_weight=o.audio_weight)
        kp_audio = m["kp_detector_a"](deco.flatten(0, 1))      # over N * Tp
        driving = {k: one_euro_filter(
            v.view(N, Tp, *v.shape[1:]).transpose(0, 1), mincutoff=0.05,
            beta=8.0, freq=100, scale=10.0).transpose(0, 1)
            for k, v in kp_audio.items()}
        return driving, kp_source

    @torch.no_grad()
    def _queue_batch(self, source_images, waveforms, poses, T: int = 0,
                     chunk: int | None = None) -> list:
        """The batched whole-clip route queued (``_queue_segments``, each
        payload [N, k, ...]), decoded in chunks of ``_batch_chunk(N)``
        frames an identity; ``T`` and ``chunk`` as ``_prepare_batch``."""
        S = max(1, self.options.overlap_segments)
        T, sources, windows, pose = self._prepare_batch(
            source_images, waveforms, poses, T, chunk)
        nhwc = sources.permute(0, 2, 3, 1)
        kv, kj, ksv, ksj, feats = self._batch_kp_impl(nhwc, windows, pose)
        return self._queue_segments(T, windows.shape[1] // S, lambda a, b: (
            self._batch_segment_impl(nhwc, feats, ksv, ksj, kv[:, a:b],
                                     kj[:, a:b])), axis=1)

    def _batch_segments(self, source_images, waveforms, poses):
        """The batched whole-clip route: yields (start frame, payload on the
        host, each [N, k, ...]) per segment.  On a mesh the N identities
        split into contiguous shards, one per device, each queued on that
        device's replica padded to the whole batch's length and segments,
        before the host waits for any copy; each segment's payloads are
        joined in identity order."""
        if self.mesh is None:
            for start, fetch in self._queue_batch(source_images, waveforms,
                                                  poses):
                yield start, fetch.result()
            return
        N = len(waveforms)
        T = max(num_windows_for_samples(np.asarray(w).reshape(-1).shape[0])
                for w in waveforms)
        chunk, queued, a = self._batch_chunk(N), [], 0
        for rep, n in zip(self._replicas, split_sizes(N, self.mesh.size)):
            if n:
                with device_context(rep.device):
                    queued.append(rep._queue_batch(
                        source_images[a:a + n], waveforms[a:a + n],
                        poses[a:a + n], T, chunk))
            a += n
        for segment in zip(*queued):
            yield segment[0][0], tuple(np.concatenate(x, axis=0) for x in zip(
                *(fetch.result() for _, fetch in segment)))

    def render_batch_uint8(self, source_images, waveforms,
                           poses) -> np.ndarray:
        """N identities' neutral clips at once: source_images
        [N,256,256,3], waveforms and poses lists of N -> uint8
        [N, T_max, 256, 256, 3]; frames past a clip's own length are its
        padded tail."""
        if self._yuv:
            return yuv420_to_rgb(*self.render_batch_yuv420(
                source_images, waveforms, poses))
        return self._join(self._batch_segments(source_images, waveforms,
                                               poses), axis=1)[0]

    def render_batch_yuv420(self, source_images, waveforms, poses):
        """``render_batch_uint8`` as yuv420p planes: (Y [N,T_max,256,256],
        U, V [N,T_max,128,128]) uint8 on the host.  Needs transfer_format
        'yuv420'."""
        if not self._yuv:
            raise ValueError(
                "render_batch_yuv420 requires transfer_format='yuv420'")
        return self._join(self._batch_segments(source_images, waveforms,
                                               poses), axis=1)

    # ------------------------------------------- the exportable functions
    # Tensors in, tensors out: what ``infer/export.py`` freezes, one
    # program per function and shape, and what the live routes above call,
    # so that a program is bitwise its live call.  Sources are NHWC float32
    # [N, 256, 256, 3] (the uploaded layout); MFCC windows, pose padding and
    # uploads stay outside, as do the copies to the host.

    def _emotion_program_input(self, frames: torch.Tensor,
                               frame_index: torch.Tensor,
                               table: bool = False) -> EmotionInput:
        """Emotion frames as uploaded (``_upload_emotion``'s formats) and the
        timestep -> frame index -> the emotion stage's input: the frames
        (the raw-frames route of a whole clip), or with ``table`` and the
        linear head a handle's trunk feature table (``emotion_table``; the
        unbounded route)."""
        decoded = self._decode_emotion(frames)
        if table and self._trunk_route():
            return EmotionInput(self.emotion_table(decoded), frame_index,
                                True)
        return EmotionInput(decoded, frame_index, False)

    @torch.no_grad()
    def _kp_stage_from_windows_impl(self, source, windows, pose,
                                    emotion_frames=None,
                                    frame_index=None) -> tuple:
        """One clip's keypoint stage from its MFCC windows [Tp, 28, 12] and
        pose [Tp, 6], emotional with ``emotion_frames`` (as uploaded) and
        ``frame_index`` [Tp] -> (normalized driving kp value [Tp, K, 2],
        jacobian [Tp, K, 2, 2], source kp value [K, 2], jacobian
        [K, 2, 2], encoded source features)."""
        src = source.permute(0, 3, 1, 2)
        kp_s, driving, kp_initial = self.audio_keypoints(src, windows, pose)
        emotion = (None if emotion_frames is None else
                   self._emotion_program_input(emotion_frames, frame_index))
        kp_norm = self.emotion_keypoints(kp_s, driving, kp_initial, emotion)
        _, feats = self.source_features(src)
        return (kp_norm["value"], kp_norm["jacobian"], kp_s["value"],
                kp_s["jacobian"], feats)

    @torch.no_grad()
    def _render_segment_impl(self, source, feats, kp_s_value, kp_s_jacobian,
                             kp_value, kp_jacobian) -> tuple:
        """The frames of one clip's driving kp [n, ...] in chunks of
        ``frame_chunk`` -> the payload, each tensor [n, ...]."""
        src = source.permute(0, 3, 1, 2).to(self.options.compute_dtype)
        return self._decode_one(
            src, feats, {"value": kp_value, "jacobian": kp_jacobian},
            {"value": kp_s_value, "jacobian": kp_s_jacobian}, 0,
            kp_value.shape[0])

    def _emo_render_from_windows_impl(self, source, windows, pose,
                                      emotion_frames, frame_index) -> tuple:
        """The emotional whole clip: ``_kp_stage_from_windows_impl`` then
        ``_render_segment_impl`` over every frame -> the payload [Tp, ...]."""
        kv, kj, ksv, ksj, feats = self._kp_stage_from_windows_impl(
            source, windows, pose, emotion_frames, frame_index)
        return self._render_segment_impl(source, feats, ksv, ksj, kv, kj)

    @torch.no_grad()
    def _batch_kp_impl(self, sources, windows, pose) -> tuple:
        """N neutral clips' keypoint stage (``batch_keypoints``): windows
        [N, Tp, 28, 12], pose [N, Tp, 6] -> (driving kp value [N, Tp, K, 2],
        jacobian, source kp value [N, K, 2], jacobian, encoded sources)."""
        src = sources.permute(0, 3, 1, 2)
        driving, kp_source = self.batch_keypoints(src, windows, pose)
        _, feats = self.source_features(src)
        return (driving["value"], driving["jacobian"], kp_source["value"],
                kp_source["jacobian"], feats)

    @torch.no_grad()
    def _batch_segment_impl(self, sources, feats, kp_s_value, kp_s_jacobian,
                            kp_value, kp_jacobian) -> tuple:
        """N identities' frames of driving kp [N, n, ...], identity-major in
        chunks of ``_batch_chunk(N)`` -> the payload, each [N, n, ...]."""
        src = sources.permute(0, 3, 1, 2).to(self.options.compute_dtype)
        return self.decode_frames(
            src, feats, {"value": kp_value, "jacobian": kp_jacobian},
            {"value": kp_s_value, "jacobian": kp_s_jacobian}, 0,
            kp_value.shape[1], self._batch_chunk(src.shape[0]))

    def _batch_render_impl(self, sources, windows, pose) -> tuple:
        """N neutral clips whole: ``_batch_kp_impl`` then
        ``_batch_segment_impl`` over every frame -> the payload
        [N, Tp, ...]."""
        kv, kj, ksv, ksj, feats = self._batch_kp_impl(sources, windows, pose)
        return self._batch_segment_impl(sources, feats, ksv, ksj, kv, kj)

    def _stream_kp_chunk_impl(self, kp_s_value, kp_s_jacobian, image_feature,
                              samples, pose, *rest, emotional: bool = False,
                              first: bool = True) -> tuple:
        """One unbounded chunk's keypoints (``_stream_kp_chunk``) with
        tensors in and out: ``rest`` is (emotion frames as uploaded, frame
        index [K]) when ``emotional``, then, unless ``first``, the carry
        as ``_stream_kp_chunk_impl`` returned it -> (normalized kp value
        [K, K_kp, 2], jacobian, *carry) with the carry flattened in
        ``carry_names(emotional)`` order."""
        emotion = None
        if emotional:
            frames, index, *rest = rest
            emotion = self._emotion_program_input(frames, index, table=True)
        carry = None if first else unflatten_carry(rest, emotional)
        kp_norm, carry = self._stream_kp_chunk(
            {"value": kp_s_value, "jacobian": kp_s_jacobian}, image_feature,
            samples, pose, emotion, carry)
        return (kp_norm["value"], kp_norm["jacobian"],
                *flatten_carry(carry, emotional))

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
    def from_torch_checkpoints(cls, config: dict, fomm_path: str,
                               audio_path: str, emo_path: str,
                               options: PipelineOptions | None = None
                               ) -> "EammPipeline":
        """The reference's three checkpoints: FOMM {generator, kp_detector},
        audio {audio_feature, kp_detector_a}, emotion {emo_detector}.  Each
        model loads strictly on the CPU, its ``module.`` prefixes dropped,
        then moves to the options' device.  The emotion file's ``final_4``
        stack, which no head runs and EmotionK does not hold, and the
        audio file's decoder of the other ``jaco_net``
        (``compat.ATNET_UNUSED``) are skipped and named in
        ``ignored_keys``."""
        options = options or PipelineOptions()
        sds = compat.model_state_dicts(
            *(compat.load_torch_checkpoint(p)
              for p in (fomm_path, audio_path, emo_path)))
        models = cfg.build_all(config, _emotion_kind(options.emo_type))
        ignored = {}
        for name, model in models.items():
            sd, ignored[name] = compat.split_unused(
                sds[name], model, compat.unused_prefixes(name, model))
            model.load_state_dict(sd)
        pipe = cls(config, options=options, models=models)
        pipe.ignored_keys = {k: v for k, v in ignored.items() if v}
        return pipe

    @classmethod
    def from_jax_variables(cls, config: dict, variables: dict,
                           options: PipelineOptions | None = None
                           ) -> "EammPipeline":
        """Weights of a JAX ``EammPipeline`` (its ``vars``, leaves as numpy
        arrays), through ``convert.state_dicts_from_jax``."""
        options = options or PipelineOptions()
        return cls(config, state_dicts_from_jax(variables, options.emo_type),
                   options)
