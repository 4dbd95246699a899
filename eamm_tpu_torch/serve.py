"""Serving: dynamic request batching over the batched render (PyTorch).

Counterpart of ``eamm_tpu/serve.py``, with the same contract.
``RenderServer`` wraps an ``EammPipeline`` with one daemon worker thread,
which does all of the server's device work:

1. it blocks on the first queued request, then waits up to
   ``max_delay_ms`` for more (dynamic batching);
2. neutral requests coalesce into a group of up to ``max_batch``, padded
   to exactly ``max_batch`` by replicating the first request, as in the
   JAX server (there one compiled program per batch size serves every
   group; here a padded slot is extra work on the card);
3. it runs ``render_batch_uint8`` / ``render_batch_yuv420`` and resolves
   each request's Future with its own clip, trimmed to its own length.

Emotional requests, streamed requests and clips that the pipeline's length
policy sends to the unbounded chunks (``use_unbounded``) dispatch alone.
``prepare_emotion`` runs on the worker too, so callers on other threads
(the HTTP front's handlers) only enqueue numpy arrays and wait.
``submit`` never blocks on device work.  A failing request resolves its
own Future and the worker goes on; ``stop`` resolves everything still
queued.
"""
from __future__ import annotations

import dataclasses
import queue
import threading
import time
from concurrent.futures import Future
from typing import Callable

import numpy as np

from eamm_tpu_torch.infer.pipeline import EmotionHandle
from eamm_tpu_torch.ops.mfcc import num_windows_for_samples


def _is_long(pipeline, frames: int) -> bool:
    """True when the pipeline's length policy routes a clip of ``frames``
    through the unbounded chunks (``EammPipeline.use_unbounded``)."""
    fn = getattr(pipeline, "use_unbounded", None)
    return bool(fn(frames)) if fn is not None else False


def _as_emotion_arg(transformed_video):
    """Emotion payload for a request: a prepared ``EmotionHandle`` passes
    through untouched; raw frames are cast to float32 unscaled, as the JAX
    server casts them (a uint8 clip keeps its 0..255 values)."""
    if transformed_video is None:
        return None
    if isinstance(transformed_video, EmotionHandle):
        return transformed_video
    return np.asarray(transformed_video, np.float32)


@dataclasses.dataclass
class _Request:
    source: np.ndarray
    waveform: np.ndarray
    pose: np.ndarray
    frames: int                 # true clip length for trimming
    future: Future
    t_enqueue: float
    transformed: object | None = None  # emotion frames or EmotionHandle
    stream_q: queue.Queue | None = None     # segment queue (submit_stream)
    long: bool = False   # over the pipeline's stream_policy_frames length

    @property
    def emotional(self) -> bool:
        return self.transformed is not None

    @property
    def singleton(self) -> bool:
        """Dispatched alone: emotional (per-request emotion state),
        streamed (its own delivery cadence) and long (the unbounded
        chunks) requests do not coalesce."""
        return self.emotional or self.stream_q is not None or self.long


@dataclasses.dataclass
class _Call:
    """Device work other than a render (``prepare_emotion``), run on the
    worker between dispatches; not counted in the stats."""
    fn: Callable
    future: Future
    stream_q: None = None
    singleton: bool = True


_STREAM_END = object()


class RenderServer:
    """Dynamic-batching render server (neutral requests coalesce;
    emotional, streamed and long requests dispatch alone).

    Args:
      pipeline: an ``EammPipeline`` (any transfer_format).
      max_batch: clips per coalesced dispatch; every coalesced dispatch
        runs exactly this many (short groups are padded by replication).
      max_delay_ms: how long the worker waits to fill a batch after the
        first request arrives.  Latency floor for a lone request.
    """

    def __init__(self, pipeline, max_batch: int = 4,
                 max_delay_ms: float = 50.0):
        if max_batch < 1:
            raise ValueError("max_batch must be >= 1")
        self.pipeline = pipeline
        self.max_batch = max_batch
        self.max_delay = max_delay_ms / 1e3
        self._q: queue.Queue = queue.Queue()
        self._stashed = None
        self._stop = threading.Event()
        self._lock = threading.Lock()
        self._stats = {"requests": 0, "dispatches": 0, "batched_requests": 0,
                       "latency_sum": 0.0, "latency_max": 0.0}
        self._worker = threading.Thread(target=self._loop, daemon=True)
        self._worker.start()

    # ---- client API ----------------------------------------------------

    def _enqueue(self, source_image, waveform, pose, transformed_video,
                 stream: bool) -> _Request:
        if self._stop.is_set():
            raise RuntimeError("server stopped")
        frames = num_windows_for_samples(len(waveform))   # host arithmetic
        req = _Request(np.asarray(source_image, np.float32),
                       np.asarray(waveform, np.float32),
                       np.asarray(pose, np.float32),
                       frames, Future(), time.monotonic(),
                       _as_emotion_arg(transformed_video),
                       stream_q=queue.Queue() if stream else None,
                       long=not stream and _is_long(self.pipeline, frames))
        with self._lock:
            self._stats["requests"] += 1
        self._q.put(req)
        return req

    def submit(self, source_image: np.ndarray, waveform: np.ndarray,
               pose: np.ndarray,
               transformed_video: np.ndarray | None = None) -> Future:
        """Enqueue one clip; resolves to uint8 [T, 256, 256, 3] frames
        (or (y, u, v) planes when the pipeline delivers yuv420).

        ``transformed_video`` (mouth-masked aligned emotion frames, or an
        ``EmotionHandle``) makes this an emotional request, which
        dispatches alone; neutral requests coalesce."""
        return self._enqueue(source_image, waveform, pose, transformed_video,
                             stream=False).future

    def render(self, source_image, waveform, pose,
               transformed_video=None, timeout=None):
        """Blocking convenience wrapper around ``submit``."""
        return self.submit(source_image, waveform, pose,
                           transformed_video).result(timeout)

    def prepare_emotion(self, transformed_video, timeout=None):
        """Upload an emotion clip once (and compute its trunk features) on
        the worker, for reuse across requests: pass the returned handle as
        ``transformed_video`` in later ``submit``/``submit_stream`` calls."""
        if self._stop.is_set():
            raise RuntimeError("server stopped")
        call = _Call(lambda: self.pipeline.prepare_emotion(transformed_video),
                     Future())
        self._q.put(call)
        return call.future.result(timeout)

    def submit_stream(self, source_image, waveform, pose,
                      transformed_video=None):
        """Streamed request: returns an iterator over ``(start_frame,
        payload)`` segments in clip order as the card renders them
        (``EammPipeline.render_stream``).  Streamed requests dispatch
        alone."""
        req = self._enqueue(source_image, waveform, pose, transformed_video,
                            stream=True)

        def segments():
            while True:
                item = req.stream_q.get()
                if item is _STREAM_END:
                    return
                if isinstance(item, BaseException):
                    raise item
                yield item
        return segments()

    def stats(self) -> dict:
        with self._lock:
            s = dict(self._stats)
        done = max(1, s["batched_requests"])      # completed requests
        s["mean_latency_ms"] = round(1e3 * s.pop("latency_sum") / done, 2)
        s["latency_max_ms"] = round(1e3 * s.pop("latency_max"), 2)
        s["mean_batch_occupancy"] = round(
            s["batched_requests"] / max(1, s["dispatches"]), 2)
        return s

    def reset_stats(self):
        """Zero the counters (e.g. after warm-up)."""
        with self._lock:
            for k in self._stats:
                self._stats[k] = type(self._stats[k])()

    def stop(self, timeout: float = 30.0):
        """Drain-free stop: pending requests get RuntimeError."""
        self._stop.set()
        self._q.put(None)
        self._worker.join(timeout)
        # resolve everything still queued (the submit-vs-stop race and the
        # worker's stashed request too) so no caller blocks forever
        leftovers = [self._stashed] if self._stashed else []
        self._stashed = None
        while True:
            try:
                r = self._q.get_nowait()
            except queue.Empty:
                break
            if r is not None:
                leftovers.append(r)
        for r in leftovers:
            if not r.future.done():
                r.future.set_exception(RuntimeError("server stopped"))
            if r.stream_q is not None:
                r.stream_q.put(RuntimeError("server stopped"))

    # ---- worker ---------------------------------------------------------

    def _take_group(self) -> list | None:
        first = self._stashed or self._q.get()
        self._stashed = None
        if first is None or self._stop.is_set():
            return None
        if first.singleton:
            return [first]                  # singleton dispatch
        group = [first]
        deadline = time.monotonic() + self.max_delay
        while len(group) < self.max_batch:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                break
            try:
                nxt = self._q.get(timeout=remaining)
            except queue.Empty:
                break
            if nxt is None:
                break
            if nxt.singleton:
                self._stashed = nxt         # different kind: next round
                break
            group.append(nxt)
        return group

    def _loop(self):
        while not self._stop.is_set():
            group = self._take_group()
            if not group:
                continue
            try:
                if isinstance(group[0], _Call):
                    group[0].future.set_result(group[0].fn())
                else:
                    self._dispatch(group)
            except Exception as e:   # resolve, never kill the worker
                for r in group:
                    if not r.future.done():
                        r.future.set_exception(e)
                    if r.stream_q is not None:
                        r.stream_q.put(e)

    def _dispatch(self, group: list[_Request]):
        yuv = self.pipeline.options.transfer_format == "yuv420"
        if group[0].stream_q is not None:
            r = group[0]
            try:
                count = 0
                for start, payload in self.pipeline.render_stream(
                        r.source, r.waveform, r.pose,
                        transformed_video=r.transformed,
                        add_emo=r.emotional):
                    r.stream_q.put((start, payload))
                    count += 1
            except Exception as e:
                r.stream_q.put(e)
                if not r.future.done():
                    r.future.set_exception(e)
                return
            r.stream_q.put(_STREAM_END)
            self._finish([r], [count])      # future resolves to #segments
            return
        if group[0].singleton:
            # emotional, or long (the pipeline's length policy sends it
            # through the unbounded chunks)
            r = group[0]
            if yuv:
                y, u, v = self.pipeline.render_yuv420(
                    r.source, r.waveform, r.pose,
                    transformed_video=r.transformed, add_emo=r.emotional)
                result = (y[:r.frames], u[:r.frames], v[:r.frames])
            else:
                frames = self.pipeline.render_uint8(
                    r.source, r.waveform, r.pose,
                    transformed_video=r.transformed, add_emo=r.emotional)
                result = frames[:r.frames]
            self._finish([r], [result])
            return
        # a fixed-size batch: padded by replicating request 0
        reqs = group + [group[0]] * (self.max_batch - len(group))
        sources = [r.source for r in reqs]
        wavs = [r.waveform for r in reqs]
        poses = [r.pose for r in reqs]
        if yuv:
            y, u, v = self.pipeline.render_batch_yuv420(sources, wavs, poses)
            results = [(y[i, :r.frames], u[i, :r.frames], v[i, :r.frames])
                       for i, r in enumerate(group)]
        else:
            frames = self.pipeline.render_batch_uint8(sources, wavs, poses)
            results = [frames[i, :r.frames] for i, r in enumerate(group)]
        self._finish(group, results)

    def _finish(self, group: list[_Request], results):
        now = time.monotonic()
        with self._lock:
            self._stats["dispatches"] += 1
            self._stats["batched_requests"] += len(group)
        for r, result in zip(group, results):
            lat = now - r.t_enqueue
            with self._lock:
                self._stats["latency_sum"] += lat
                self._stats["latency_max"] = max(
                    self._stats["latency_max"], lat)
            # a client-cancelled future must not poison its batchmates
            if r.future.set_running_or_notify_cancel():
                r.future.set_result(result)
