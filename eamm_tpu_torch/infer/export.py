"""The frozen render artifact: export, load, serve (counterpart of
``eamm_tpu/infer/export.py``).

One file holds the render programs, frozen by ``torch.export``, and the
weights they read: a serving host loads it and renders through
``RenderArtifact`` / ``ArtifactPipeline`` without building the models,
reading checkpoints or a config, and without retracing anything.

Layout (one ``zipfile``, written to ``path + ".tmp"`` and renamed once every
program has exported):

- ``meta.json``: format version, the device the programs were exported on
  (``device``, in place of the JAX artifact's ``platforms``), options,
  buckets, input and output specs, and each program's export seconds;
- ``programs/<name>.pt2``: one ``torch.export.save`` program per bucket and
  kind, the JAX artifact's names: ``NxT`` (the batched render of N
  identities, T padded frames), ``emo_TxU`` (one emotional clip, U padded
  unique emotion frames), ``kp_T`` / ``kp_emo_TxU`` and ``seg_T`` (the
  streamed clip's keypoint stage and one of its segments), ``u_prelude``,
  ``u_kp_first`` / ``u_kp_next`` (``u_kp_emoU_first`` / ``_next``) and
  ``u_seg`` (the unbounded chunks);
- ``weights.pt``: the weights, once.  Every program is a function of
  (weights, inputs...): the models' parameters and buffers, the folded eval
  forms among them (``models/blocks.py`` ``FoldedWeights``), are its first
  input, lifted through ``torch.func.functional_call``, so no program holds
  a copy of them and the loaded programs read the loaded weights.

The programs are the pipeline's ``*_impl`` functions, which its live routes
call too, so a program renders bitwise what the live route renders on the
same device from the same inputs.  The CUDA kernels are ``eamm::``
operators (``ops/warp_cuda.py``, ``ops/kp_expectation.py``), which
``torch.export`` keeps as calls: a program exported on the card launches
them, one exported on the CPU runs their plain versions.  Tables that the
traced code caches on the device (the MFCC and antialias tables) become
program constants on the export device, so a program runs only there: the
loader refuses another device.  MFCC windows, pose preparation, padding,
the uploads and the copies to the host stay outside the programs, as in the
JAX package.  ``torch.export`` unrolls Python loops: the one-euro filters
over T, the decode chunks, so a program's export time grows with its
bucket (``meta["export_seconds"]``).
"""
from __future__ import annotations

import functools
import io
import json
import math
import os
import time
import zipfile

import numpy as np
import torch
import torch.nn as nn

from eamm_tpu_torch.infer.pipeline import (PipelineOptions, carry_names,
                                           prepare_pose_np, upload_sources)
from eamm_tpu_torch.models.blocks import refold_all
from eamm_tpu_torch.ops.colorspace import pack_yuv420_np
from eamm_tpu_torch.ops.mfcc import (PAD_SAMPLES, audio_to_mfcc_windows,
                                     chunk_sample_start, chunk_samples_len,
                                     min_samples_for_windows,
                                     num_windows_for_samples,
                                     padded_buffer_len)
from eamm_tpu_torch.utils.transfer import Link

FORMAT_VERSION = 1
_EMO_MODELS = ("kp_detector", "kp_detector_a", "audio_feature",
               "emo_detector")


class _Models(nn.Module):
    """Every model a program reads, each registered once (the generator and
    emotion trunk in ``compute_dtype``), so that their weights are one
    state: ``forward(fn, *inputs)`` runs ``fn`` while
    ``functional_call`` has those weights swapped in."""

    def __init__(self, pipeline):
        super().__init__()
        self.generator = pipeline.generator
        for name in _EMO_MODELS:
            self.add_module(name, pipeline.models[name])
        trunk = pipeline.emotion_trunk
        if trunk is not None and trunk is not pipeline.models["emo_detector"]:
            self.emotion_trunk = trunk        # a copy in compute_dtype

    def forward(self, fn, *inputs):
        return fn(*inputs)


class _Program(nn.Module):
    """``fn`` as a function of (weights, *inputs).  The models are held
    outside the module's registry, so the program lifts no parameter of
    its own: the weights are an input."""

    def __init__(self, models: _Models, fn):
        super().__init__()
        self.__dict__["_models"] = models
        self.__dict__["_fn"] = fn

    def forward(self, weights: dict, *inputs):
        return torch.func.functional_call(self._models, weights,
                                          (self._fn, *inputs))


def _zeros_like_outputs(ep) -> list:
    """Zero tensors shaped as ``ep``'s outputs (example inputs of the next
    program)."""
    out = next(n for n in ep.graph.nodes if n.op == "output")
    return [torch.zeros(v.shape, dtype=v.dtype, device=v.device)
            for v in (a.meta["val"] for a in out.args[0])]


def export_render_artifact(pipeline, path: str, batch: int = 1,
                           frame_buckets=(128,), emotional: bool = False,
                           emo_frame_buckets=(32,), stream_segments: int = 0,
                           unbounded_frames: int = 0) -> dict:
    """Export ``pipeline``'s render programs and weights to ``path``, on
    the pipeline's device (a CUDA pipeline's programs launch the kernels).

    batch: identities N of the batched program; frame_buckets: padded clip
    lengths, one batched program each, multiples of the batch chunk.
    emotional: also one-clip emotional programs, one per frame bucket and
    ``emo_frame_buckets`` (padded unique emotion frames) pair, with an
    explicit timestep -> frame index.  stream_segments: also one-clip
    streaming programs (a keypoint stage per bucket, per emotion bucket
    too when ``emotional``, and a segment decode per bucket) that deliver
    the clip in that many in-order segments.  unbounded_frames: also the
    unbounded chunk programs at that many frames a chunk (a prelude, a
    first and a next keypoint chunk that thread the recurrent state, a
    chunk decode), which serve any length; ``ArtifactPipeline`` routes
    clips past ``stream_policy_frames`` (or the largest bucket) there.
    Returns the meta dict written into the artifact."""
    o = pipeline.options
    if o.check_add:
        raise ValueError("check_add pipelines are not exported: the "
                         "unbounded chunks carry the audio filters' states")
    chunk = pipeline._batch_chunk(batch)
    for t in frame_buckets:
        if t % chunk:
            raise ValueError(f"frame bucket {t} is not a multiple of the "
                             f"render chunk {chunk} at batch {batch}")
        if emotional and t % o.frame_chunk:
            raise ValueError(
                f"frame bucket {t} is not a multiple of the single-clip "
                f"render chunk {o.frame_chunk} (emotional programs)")
        if stream_segments and t % (o.frame_chunk * stream_segments):
            raise ValueError(
                f"frame bucket {t} does not divide into {stream_segments} "
                f"segments of whole render chunks (chunk {o.frame_chunk})")
    if unbounded_frames and unbounded_frames % o.frame_chunk:
        raise ValueError(f"unbounded_frames {unbounded_frames} is not a "
                         f"multiple of the render chunk {o.frame_chunk}")

    dev = pipeline.device
    models = _Models(pipeline)
    refold_all(models)
    weights = {**dict(models.named_parameters()),
               **dict(models.named_buffers())}
    yuv = o.transfer_format == "yuv420"
    frames_dtype = "yuv420" if yuv else "float32"
    meta = {
        "format_version": FORMAT_VERSION,
        "batch": int(batch),
        "frame_buckets": [int(t) for t in frame_buckets],
        "device": str(dev),
        "transfer_format": o.transfer_format,
        "compute_dtype": str(o.compute_dtype).removeprefix("torch."),
        "smooth_pose": bool(o.smooth_pose),
        "frame_chunk": int(chunk),
        "inputs": "weights (weights.pt); sources [N,256,256,3] f32 in "
                  "[0,1]; mfcc_windows [N,T,28,12] f32; pose [N,T,6] f32",
        "outputs": "uint8 frames [N,T,256,256,3]" if not yuv else
        "uint8 yuv420 planes (y [N,T,256,256], u/v [N,T,128,128])",
        "emotional": {
            "frame_buckets": [int(t) for t in frame_buckets],
            "emo_frame_buckets": [int(u) for u in emo_frame_buckets],
            "emo_type": o.emo_type,
            "frames_dtype": frames_dtype,
            "inputs": "source [1,256,256,3] f32; mfcc_windows [T,28,12] "
                      "f32; pose [T,6] f32; emotion_frames [U,384,256] u8 "
                      "packed yuv420 or [U,256,256,3] f32 (mouth-masked, "
                      "aligned); frame_index [T] i64",
        } if emotional else None,
        "streaming": {
            "segments": int(stream_segments),
            "fetch_streams": int(max(1, o.fetch_streams)),
            "frame_buckets": [int(t) for t in frame_buckets],
            "emotional": bool(emotional),
        } if stream_segments else None,
        "unbounded": {
            "segment_frames": int(unbounded_frames),
            "fetch_streams": int(max(1, o.fetch_streams)),
            "emotional": bool(emotional),
            "emo_frame_buckets": [int(u) for u in emo_frame_buckets]
            if emotional else [],
            "frames_dtype": frames_dtype,
            "stream_policy_frames": o.stream_policy_frames,
            "carry": carry_names(emotional),
        } if unbounded_frames else None,
        "export_seconds": {},
    }

    def zeros(*shape, dtype=torch.float32):
        return torch.zeros(shape, dtype=dtype, device=dev)

    def emo_frames(u):
        return (zeros(u, 384, 256, dtype=torch.uint8) if yuv
                else zeros(u, 256, 256, 3))

    src1 = zeros(1, 256, 256, 3)
    tmp = path + ".tmp"
    try:
        with zipfile.ZipFile(tmp, "w", zipfile.ZIP_STORED) as z:
            def put(name, fn, *inputs):
                t0 = time.perf_counter()
                with torch.no_grad():     # the models' no_grad is then moot
                    ep = torch.export.export(_Program(models, fn),
                                             (weights, *inputs), strict=False)
                ep.example_inputs = None   # else saved: the weights again
                buf = io.BytesIO()
                torch.export.save(ep, buf)
                z.writestr(f"programs/{name}.pt2", buf.getvalue())
                meta["export_seconds"][name] = time.perf_counter() - t0
                return ep

            for t in frame_buckets:
                put(f"{batch}x{t}", pipeline._batch_render_impl,
                    zeros(batch, 256, 256, 3), zeros(batch, t, 28, 12),
                    zeros(batch, t, 6))
            if emotional:
                for t in frame_buckets:
                    for u in emo_frame_buckets:
                        put(f"emo_{t}x{u}",
                            pipeline._emo_render_from_windows_impl, src1,
                            zeros(t, 28, 12), zeros(t, 6), emo_frames(u),
                            zeros(t, dtype=torch.int64))
            if stream_segments:
                kp = pipeline._kp_stage_from_windows_impl
                for t in frame_buckets:
                    ep = put(f"kp_{t}", kp, src1, zeros(t, 28, 12),
                             zeros(t, 6))
                    kv, kj, ksv, ksj, feats = _zeros_like_outputs(ep)
                    n = t // stream_segments
                    put(f"seg_{t}", pipeline._render_segment_impl, src1,
                        feats, ksv, ksj, kv[:n], kj[:n])
                    if emotional:
                        for u in emo_frame_buckets:
                            put(f"kp_emo_{t}x{u}", kp, src1,
                                zeros(t, 28, 12), zeros(t, 6),
                                emo_frames(u), zeros(t, dtype=torch.int64))
            if unbounded_frames:
                K = int(unbounded_frames)
                ep = put("u_prelude", pipeline._stream_prelude_impl, src1)
                ksv, ksj, imgf, feats = _zeros_like_outputs(ep)
                head = (ksv, ksj, imgf, zeros(1 + chunk_samples_len(K)),
                        zeros(K, 6))
                chunk_fn = pipeline._stream_kp_chunk_impl

                def chunk_pair(tag, emo_inputs):
                    kw = dict(emotional=bool(emo_inputs))
                    ep = put(f"u_kp_{tag}first",
                             functools.partial(chunk_fn, first=True, **kw),
                             *head, *emo_inputs)
                    kv, kj, *carry = _zeros_like_outputs(ep)
                    put(f"u_kp_{tag}next",
                        functools.partial(chunk_fn, first=False, **kw),
                        *head, *emo_inputs, *carry)
                    return kv, kj

                kv, kj = chunk_pair("", ())
                if emotional:
                    for u in emo_frame_buckets:
                        chunk_pair(f"emo{u}_", (emo_frames(u),
                                                zeros(K, dtype=torch.int64)))
                put("u_seg", pipeline._render_segment_impl, src1, feats,
                    ksv, ksj, kv, kj)
            buf = io.BytesIO()
            torch.save({k: v.detach().cpu() for k, v in weights.items()}, buf)
            z.writestr("weights.pt", buf.getvalue())
            z.writestr("meta.json", json.dumps(meta, indent=1))
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return meta


def flatten_lstm_weights(weights: dict) -> None:
    """Make each LSTM's loaded weights (``<prefix>.weight_ih_l<i>`` ...)
    views of one flat buffer in cuDNN's layout, in place, as
    ``nn.LSTM.flatten_parameters()`` does for a live module: cuDNN then
    reads them where they are, instead of compacting a copy at every call.
    Nothing to do off CUDA."""
    for key in [k for k in weights if k.endswith(".weight_ih_l0")]:
        prefix = key[:-len(".weight_ih_l0")]
        w_ih = weights[key]
        if w_ih.device.type != "cuda" or \
                not torch.backends.cudnn.is_acceptable(w_ih) or \
                not torch._use_cudnn_rnn_flatten_weight():
            continue
        import torch.backends.cudnn.rnn as cudnn_rnn
        layers = 0
        while f"{prefix}.weight_ih_l{layers}" in weights:
            layers += 1
        bias = f"{prefix}.bias_ih_l0" in weights
        names = ("weight_ih", "weight_hh") + (("bias_ih", "bias_hh")
                                              if bias else ())
        flat = [weights[f"{prefix}.{n}_l{i}"] for i in range(layers)
                for n in names]
        hidden = weights[f"{prefix}.weight_hh_l0"].shape[1]
        with torch.no_grad():
            torch._cudnn_rnn_flatten_weight(
                flat, len(names), w_ih.shape[1],
                cudnn_rnn.get_cudnn_mode("LSTM"), hidden, 0,
                layers, True, False)


class RenderArtifact:
    """A loaded render artifact: the frozen programs, their weights on the
    device they were exported on, and the host side that feeds them."""

    def __init__(self, meta: dict, programs: dict, weights: dict,
                 device: torch.device):
        self.meta = meta
        self._programs = programs          # name -> callable(weights, ...)
        self.weights = weights
        self.device = device
        self.link = Link(device)
        self.batch = int(meta["batch"])
        self.frame_buckets = sorted(int(t) for t in meta["frame_buckets"])

    @classmethod
    def load(cls, path: str, device: str = "cuda") -> "RenderArtifact":
        """Load on ``device`` (the card unless the caller asks for the CPU);
        refuses an artifact of another format version or exported on
        another kind of device."""
        dev = torch.device(device)
        with zipfile.ZipFile(path) as z:
            meta = json.loads(z.read("meta.json"))
            if meta.get("format_version") != FORMAT_VERSION:
                raise ValueError(f"artifact format {meta.get('format_version')}"
                                 f", this loader reads {FORMAT_VERSION}")
            exported_on = torch.device(meta["device"])
            if exported_on.type != dev.type:
                raise ValueError(f"artifact exported on {exported_on}: its "
                                 f"programs run there, not on {dev}")
            weights = torch.load(io.BytesIO(z.read("weights.pt")),
                                 map_location=exported_on, weights_only=True)
            flatten_lstm_weights(weights)
            programs = {}
            for name in z.namelist():
                if name.startswith("programs/"):
                    ep = torch.export.load(io.BytesIO(z.read(name)))
                    programs[name[len("programs/"):-len(".pt2")]] = ep.module()
        return cls(meta, programs, weights, exported_on)

    def _call(self, name: str, *inputs) -> tuple:
        with torch.no_grad():
            return tuple(self._programs[name](self.weights, *inputs))

    def bucket_for(self, frames: int, buckets=None) -> int:
        buckets = sorted(buckets or self.frame_buckets)
        for t in buckets:
            if frames <= t:
                return t
        raise ValueError(f"clip of {frames} frames exceeds the largest "
                         f"exported bucket ({buckets[-1]})")

    @property
    def _yuv(self) -> bool:
        return self.meta["transfer_format"] == "yuv420"

    # ----------------------------------------------------- host side

    def _tensor(self, array, dtype=np.float32) -> torch.Tensor:
        return self.link.upload(np.ascontiguousarray(array, dtype))

    def _prepare_single(self, source, waveform, pose, buckets=None):
        """One clip as the live whole-clip route pads it, to the smallest
        bucket that fits: -> (T, Tp, source [1,256,256,3], windows
        [Tp,28,12], pose [Tp,6]) on the device."""
        wav = np.asarray(waveform, np.float32).reshape(-1)
        T = num_windows_for_samples(wav.shape[0])
        tp = self.bucket_for(T, buckets)
        wav_p = np.zeros(max(wav.shape[0], min_samples_for_windows(tp)),
                         np.float32)
        wav_p[:wav.shape[0]] = wav
        pose_p = np.zeros((tp, 6), np.float32)
        pose_p[:T] = prepare_pose_np(pose, T,
                                     smooth=self.meta.get("smooth_pose", True))
        windows = audio_to_mfcc_windows(self._tensor(wav_p))[:tp]
        return (T, tp, upload_sources(source, self.device), windows,
                self._tensor(pose_p))

    def _prepare_batch(self, sources, waveforms, poses):
        """N clips as the live batched route pads them: each clip's windows
        from its own waveform, windows and poses zero-padded to the bucket
        of the longest -> (T, sources, windows [N,Tp,28,12], pose
        [N,Tp,6]) on the device."""
        windows = [audio_to_mfcc_windows(self._tensor(np.asarray(
            w, np.float32).reshape(-1))) for w in waveforms]
        T = max(w.shape[0] for w in windows)
        return (T, upload_sources(sources, self.device),
                *self._pad_batch(windows, poses))

    def _pad_batch(self, windows, poses):
        """Windows (device) and poses of N clips, zero-padded to the bucket
        of the longest -> (windows [N,Tp,28,12], pose [N,Tp,6])."""
        N = len(windows)
        tp = self.bucket_for(max(w.shape[0] for w in windows))
        win = windows[0].new_zeros((N, tp, *windows[0].shape[1:]))
        pose = np.zeros((N, tp, 6), np.float32)
        for i, w in enumerate(windows):
            win[i, :w.shape[0]] = w
            pose[i, :w.shape[0]] = prepare_pose_np(
                poses[i], w.shape[0], smooth=self.meta.get("smooth_pose",
                                                           True))
        return win, self._tensor(pose)

    def _emotion_inputs(self, emotion_frames, buckets, frames_dtype,
                        cut: int | None = None):
        """Unique emotion frames (float32 in [0, 1], or 0..255 as the server
        casts them), cut to ``cut`` -> (the frames padded to the smallest
        emotion bucket in the traced upload format, on the device, and
        their true count)."""
        ef = np.asarray(emotion_frames, np.float32)
        u = ef.shape[0] if cut is None else min(ef.shape[0], cut)
        up = self.bucket_for(u, buckets)
        if frames_dtype == "yuv420":
            frames = np.zeros((up, 384, 256), np.uint8)
            frames[:u] = pack_yuv420_np(ef[:u])
        else:
            frames = np.zeros((up, 256, 256, 3), np.float32)
            frames[:u] = ef[:u]
        return self.link.upload(frames), u

    def _index(self, start: int, stop: int, u: int) -> torch.Tensor:
        return torch.arange(start, stop, device=self.device) % u

    def _payload(self, parts: tuple):
        return parts if self._yuv else parts[0]

    # ----------------------------------------------------- programs

    def render(self, sources, mfcc_windows, pose):
        """The batched program on prepared inputs (windows [N,T,28,12] and
        pose [N,T,6], arrays or tensors, the time axis zero-padded to the
        bucket) -> (the payload on the device, each [N, Tp, ...], T)."""
        n, t = mfcc_windows.shape[:2]
        if n != self.batch:
            raise ValueError(f"artifact was exported at batch {self.batch}, "
                             f"got {n}")
        tp = self.bucket_for(t)
        win = torch.as_tensor(mfcc_windows, dtype=torch.float32,
                              device=self.device)
        pos = torch.as_tensor(pose, dtype=torch.float32, device=self.device)
        if tp != t:
            win = torch.cat([win, win.new_zeros((n, tp - t, 28, 12))], 1)
            pos = torch.cat([pos, pos.new_zeros((n, tp - t, 6))], 1)
        src = upload_sources(sources, self.device)
        return self._call(f"{self.batch}x{tp}", src, win, pos), t

    def _batch(self, sources, waveforms, poses) -> tuple:
        T, src, win, pose = self._prepare_batch(sources, waveforms, poses)
        if len(waveforms) != self.batch:
            raise ValueError(f"artifact was exported at batch {self.batch}, "
                             f"got {len(waveforms)}")
        parts = self._call(f"{self.batch}x{win.shape[1]}", src, win, pose)
        return self.link.fetch(parts, T, axis=1)

    def render_uint8(self, sources, waveforms, poses) -> np.ndarray:
        """N clips from raw waveforms -> uint8 [N, T, 256, 256, 3] (rgb
        artifacts)."""
        if self._yuv:
            raise ValueError("render_uint8 requires an rgb-format artifact")
        return self._batch(sources, waveforms, poses)[0]

    def render_yuv420(self, sources, waveforms, poses):
        """N clips from raw waveforms -> (y [N,T,256,256], u, v
        [N,T,128,128]) uint8 (yuv420 artifacts)."""
        if not self._yuv:
            raise ValueError("render_yuv420 requires a yuv420-format "
                             "artifact")
        return self._batch(sources, waveforms, poses)

    def render_replicated(self, source, waveform, pose):
        """One clip replicated to the exported batch (its host side once)
        -> the payload of row 0 on the host, cut to the clip."""
        wav = torch.as_tensor(np.asarray(waveform, np.float32).reshape(-1),
                              device=self.device)
        w = audio_to_mfcc_windows(wav)
        win, pos = self._pad_batch([w] * self.batch, [pose] * self.batch)
        src = upload_sources(np.broadcast_to(
            np.asarray(source, np.float32).reshape(256, 256, 3),
            (self.batch, 256, 256, 3)), self.device)
        parts = self._call(f"{self.batch}x{win.shape[1]}", src, win, pos)
        return self._payload(self.link.fetch(tuple(p[0] for p in parts),
                                             w.shape[0]))

    def render_emotional(self, source, waveform, pose, emotion_frames):
        """One emotional clip from a raw waveform through ``emo_TxU``: the
        emotion frames cut to T, padded to the bucket, cycled by an
        explicit index -> the payload on the host."""
        emo = self.meta.get("emotional")
        if not emo:
            raise ValueError("artifact was exported without emotional "
                             "programs (export with emotional=True)")
        T, tp, src, win, pos = self._prepare_single(source, waveform, pose)
        frames, u = self._emotion_inputs(emotion_frames,
                                         emo["emo_frame_buckets"],
                                         emo["frames_dtype"], cut=tp)
        parts = self._call(f"emo_{tp}x{frames.shape[0]}", src, win, pos,
                           frames, self._index(0, tp, u))
        return self._payload(self.link.fetch(parts, T))

    def render_stream(self, source, waveform, pose, emotion_frames=None):
        """A clip in the streamed programs' segments: yields (start frame,
        payload on the host) in order; every segment's decode and copy are
        queued before the host waits for the first, and segments holding
        only padding are not decoded (the live whole-clip route)."""
        stream = self.meta.get("streaming")
        if not stream:
            raise ValueError("artifact was exported without streaming "
                             "programs (export with stream_segments=N)")
        T, tp, src, win, pos = self._prepare_single(
            source, waveform, pose, stream["frame_buckets"])
        if emotion_frames is None:
            kv, kj, ksv, ksj, feats = self._call(f"kp_{tp}", src, win, pos)
        else:
            if not stream["emotional"]:
                raise ValueError("artifact was exported without emotional "
                                 "streaming programs")
            emo = self.meta["emotional"]
            frames, u = self._emotion_inputs(emotion_frames,
                                             emo["emo_frame_buckets"],
                                             emo["frames_dtype"], cut=tp)
            kv, kj, ksv, ksj, feats = self._call(
                f"kp_emo_{tp}x{frames.shape[0]}", src, win, pos, frames,
                self._index(0, tp, u))
        tseg = tp // int(stream["segments"])
        fetches = [(a, self.link.fetch_async(
            self._call(f"seg_{tp}", src, feats, ksv, ksj, kv[a:a + tseg],
                       kj[a:a + tseg]), min(tseg, T - a)))
            for a in range(0, T, tseg)]
        for start, fetch in fetches:
            yield start, self._payload(fetch.result())

    def render_stream_unbounded(self, source, waveform, pose,
                                emotion_frames=None):
        """Any length through the unbounded chunk programs: yields (start
        frame, payload on the host) per chunk; one prelude, then a keypoint
        chunk and a chunk decode per K frames with the carry threaded, at
        most two chunks in flight (the live unbounded route)."""
        ub = self.meta.get("unbounded")
        if not ub:
            raise ValueError("artifact was exported without unbounded "
                             "streaming programs (export with "
                             "unbounded_frames=K)")
        K = int(ub["segment_frames"])
        wav = np.asarray(waveform, np.float32).reshape(-1)
        T = num_windows_for_samples(wav.shape[0])
        n_chunks = max(1, math.ceil(T / K))
        # buf[1 + i] is sample i of the padded signal; buf[0] is a zero
        # before it, the first chunk's preceding sample
        buf = np.zeros(1 + max(padded_buffer_len(n_chunks * K),
                               2 * PAD_SAMPLES + wav.shape[0]), np.float32)
        buf[1 + PAD_SAMPLES:1 + PAD_SAMPLES + wav.shape[0]] = wav
        pose_full = np.zeros((n_chunks * K, 6), np.float32)
        pose_full[:T] = prepare_pose_np(
            pose, T, smooth=self.meta.get("smooth_pose", True))
        src = upload_sources(source, self.device)
        emo, tag = (), ""
        if emotion_frames is not None:
            if not ub["emotional"]:
                raise ValueError("artifact was exported without emotional "
                                 "unbounded programs")
            frames, u = self._emotion_inputs(
                emotion_frames, ub["emo_frame_buckets"], ub["frames_dtype"])
            tag = f"emo{frames.shape[0]}_"
        ksv, ksj, imgf, feats = self._call("u_prelude", src)
        n_samples = 1 + chunk_samples_len(K)
        carry, pending = (), []
        for c in range(n_chunks):
            s0 = chunk_sample_start(c * K)
            if emotion_frames is not None:
                emo = (frames, self._index(c * K, (c + 1) * K, u))
            if len(pending) == 2:
                start, fetch = pending.pop(0)
                yield start, self._payload(fetch.result())
            kv, kj, *carry = self._call(
                f"u_kp_{tag}{'next' if c else 'first'}", ksv, ksj, imgf,
                self.link.upload(buf[s0:s0 + n_samples]),
                self.link.upload(pose_full[c * K:(c + 1) * K]), *emo, *carry)
            pending.append((c * K, self.link.fetch_async(
                self._call("u_seg", src, feats, ksv, ksj, kv, kj),
                min(K, T - c * K))))
        for start, fetch in pending:
            yield start, self._payload(fetch.result())


class ArtifactPipeline:
    """``RenderServer``'s pipeline over a loaded artifact
    (``eamm-torch-serve --artifact``), as the JAX package's: coalesced
    neutral batches run the batched program (the server's ``max_batch``
    is the artifact's batch; it pads short groups), emotional singletons the
    emotional program, streams the streamed programs (one whole-clip
    segment without them), and clips past the length policy the unbounded
    chunks.  It has no ``prepare_emotion``: an emotion clip is registered
    with a live pipeline only."""

    def __init__(self, artifact: RenderArtifact):
        self.artifact = artifact
        meta = artifact.meta
        self.options = PipelineOptions(
            add_emo=bool(meta.get("emotional")),
            transfer_format=meta["transfer_format"],
            smooth_pose=bool(meta.get("smooth_pose", True)),
            device=str(artifact.device))

    def use_unbounded(self, frames: int) -> bool:
        """Clips longer than the artifact's ``stream_policy_frames``, or its
        largest whole-clip bucket, take the unbounded chunks, when
        exported."""
        ub = self.artifact.meta.get("unbounded")
        if not ub:
            return False
        largest = max(self.artifact.frame_buckets)
        policy = ub.get("stream_policy_frames")
        return frames > min(largest, largest if policy is None
                            else int(policy))

    def _frames_for(self, waveform) -> int:
        return num_windows_for_samples(
            np.asarray(waveform).reshape(-1).shape[0])

    def render_batch_uint8(self, sources, waveforms, poses):
        return self.artifact.render_uint8(sources, waveforms, poses)

    def render_batch_yuv420(self, sources, waveforms, poses):
        return self.artifact.render_yuv420(sources, waveforms, poses)

    def _render(self, source, waveform, pose, transformed_video, add_emo):
        add_emo = self.options.add_emo if add_emo is None else add_emo
        if add_emo and transformed_video is None:
            raise ValueError("add_emo requires transformed_video frames")
        video = transformed_video if add_emo else None
        if self.use_unbounded(self._frames_for(waveform)):
            parts = [p for _, p in self.artifact.render_stream_unbounded(
                source, waveform, pose, video)]
            if self.artifact._yuv:
                return tuple(np.concatenate(x, axis=0) for x in zip(*parts))
            return np.concatenate(parts, axis=0)
        if add_emo:
            return self.artifact.render_emotional(source, waveform, pose,
                                                  video)
        return self.artifact.render_replicated(source, waveform, pose)

    def render_uint8(self, source, waveform, pose, transformed_video=None,
                     add_emo=None):
        if self.options.transfer_format != "rgb":
            raise ValueError("render_uint8 requires an rgb-format artifact")
        return self._render(source, waveform, pose, transformed_video,
                            add_emo)

    def render_yuv420(self, source, waveform, pose, transformed_video=None,
                      add_emo=None):
        if self.options.transfer_format != "yuv420":
            raise ValueError("render_yuv420 requires a yuv420-format "
                             "artifact")
        return self._render(source, waveform, pose, transformed_video,
                            add_emo)

    def render_stream(self, source, waveform, pose, transformed_video=None,
                      add_emo=None):
        """Segments of the streamed programs when exported; the unbounded
        chunks past the length policy; else one whole-clip segment."""
        add_emo = self.options.add_emo if add_emo is None else add_emo
        if add_emo and transformed_video is None:
            raise ValueError("add_emo requires transformed_video frames")
        video = transformed_video if add_emo else None
        if self.use_unbounded(self._frames_for(waveform)):
            yield from self.artifact.render_stream_unbounded(
                source, waveform, pose, video)
            return
        stream = self.artifact.meta.get("streaming")
        if stream and (not add_emo or stream["emotional"]):
            yield from self.artifact.render_stream(source, waveform, pose,
                                                   video)
            return
        yield 0, self._render(source, waveform, pose, transformed_video,
                              add_emo)
