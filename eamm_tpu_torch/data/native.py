"""Uncompressed AVI writers (pure Python): the demo's video output, with
the driving audio muxed in as a 16-bit PCM stream, playable without a
codec or ffmpeg.

Counterpart of ``eamm_tpu/data/native.py``'s ``write_avi_rgb`` and
``write_avi_i420``, byte for byte the same files; the JAX package writes
them with a C++ muxer when it builds and with this muxer otherwise.  The
libpng batch decoder of that module is not ported.
"""
from __future__ import annotations

import struct

import numpy as np


def pcm16(audio, sample_rate: int = 16000):
    """Normalize an audio argument to (int16 [S] or [S, C] array, rate).

    Accepts int16 arrays as-is, float waveforms in [-1, 1] (the
    ``load_audio`` output), or an (array, rate) tuple."""
    if audio is None:
        return None, 0
    if isinstance(audio, tuple):
        audio, sample_rate = audio
    audio = np.asarray(audio)
    if audio.dtype != np.int16:
        audio = (np.clip(audio.astype(np.float32), -1.0, 1.0)
                 * 32767.0).round().astype(np.int16)
    return np.ascontiguousarray(audio), int(sample_rate)


def _fps_rational(fps: float) -> tuple[int, int]:
    return max(1, int(round(fps * 1000))), 1000


def _py_avi(path, n, w, h, fps, frame_size, bit_count, compression,
            handler, frames_iter, pcm=None, sample_rate=0):
    """The AVI muxer: a RIFF 'AVI ' file of ``n`` video chunks of
    ``frame_size`` bytes and, with ``pcm``, an interleaved 16-bit PCM
    'auds' stream cut at the frame times (the wire format of the JAX
    package's native/avi_writer.cc)."""
    num, den = _fps_rational(fps)
    avih, strh = 56, 56
    strl_vid = 4 + 8 + strh + 8 + 40
    have_audio = pcm is not None and pcm.size > 0
    channels = 0 if not have_audio else (1 if pcm.ndim == 1 else pcm.shape[1])
    ba = channels * 2
    hdrl = 4 + 8 + avih + 8 + strl_vid
    if have_audio:
        strl_aud = 4 + 8 + strh + 8 + 16
        hdrl += 8 + strl_aud
        n_samples = pcm.shape[0]
        cuts = [min(i * sample_rate * den // num, n_samples)
                for i in range(n)] + [n_samples]
        aud_bytes = [(cuts[i + 1] - cuts[i]) * ba for i in range(n)]
    else:
        aud_bytes = [0] * n
    movi = 4 + n * (8 + frame_size) + sum(8 + b for b in aud_bytes if b)
    idx1 = (n + sum(1 for b in aud_bytes if b)) * 16
    riff = 4 + 8 + hdrl + 8 + movi + 8 + idx1
    with open(path, "wb") as f:
        w32 = lambda *v: f.write(struct.pack("<" + "I" * len(v), *v))
        f.write(b"RIFF"); w32(riff); f.write(b"AVI ")
        f.write(b"LIST"); w32(hdrl); f.write(b"hdrl")
        f.write(b"avih"); w32(avih, 1000000 * den // num, frame_size * num // den,
                              0, 0x110 if have_audio else 0x10, n, 0,
                              2 if have_audio else 1,
                              frame_size, w, h, 0, 0, 0, 0)
        f.write(b"LIST"); w32(strl_vid); f.write(b"strl")
        f.write(b"strh"); w32(strh); f.write(b"vids"); f.write(handler)
        w32(0, 0, 0, den, num, 0, n, frame_size, 0xFFFFFFFF, 0)
        f.write(struct.pack("<4H", 0, 0, w, h))
        f.write(b"strf"); w32(40, 40, w, h)
        f.write(struct.pack("<2H", 1, bit_count))
        w32(compression, frame_size, 0, 0, 0, 0)
        if have_audio:
            f.write(b"LIST"); w32(strl_aud); f.write(b"strl")
            f.write(b"strh"); w32(strh); f.write(b"auds")
            w32(0, 0, 0, 0, 1, sample_rate, 0, n_samples,
                max(aud_bytes), 0xFFFFFFFF, ba)
            f.write(struct.pack("<4H", 0, 0, 0, 0))
            f.write(b"strf"); w32(16)
            f.write(struct.pack("<2H", 1, channels))
            w32(sample_rate, sample_rate * ba)
            f.write(struct.pack("<2H", ba, 16))
        f.write(b"LIST"); w32(movi); f.write(b"movi")
        for i, data in enumerate(frames_iter):
            f.write(b"00db"); w32(frame_size); f.write(data)
            if have_audio and aud_bytes[i]:
                f.write(b"01wb"); w32(aud_bytes[i])
                f.write(pcm[cuts[i]:cuts[i + 1]].tobytes())
        f.write(b"idx1"); w32(idx1)
        off = 4
        for i in range(n):
            f.write(b"00db"); w32(0x10, off, frame_size)
            off += 8 + frame_size
            if have_audio and aud_bytes[i]:
                f.write(b"01wb"); w32(0x10, off, aud_bytes[i])
                off += 8 + aud_bytes[i]
    return path


def write_avi_rgb(path: str, frames: np.ndarray, fps: float = 25.0,
                  audio=None, sample_rate: int = 16000) -> str:
    """Mux [N, H, W, 3] uint8 RGB frames into an uncompressed DIB AVI
    (bottom-up BGR rows padded to 4 bytes).  ``audio`` (float waveform in
    [-1, 1], int16 PCM, or an (array, rate) tuple) adds an interleaved
    16-bit 'auds' stream."""
    frames = np.ascontiguousarray(frames, np.uint8)
    n, h, w = frames.shape[:3]
    pcm, rate = pcm16(audio, sample_rate)
    stride = (w * 3 + 3) & ~3

    def gen():
        pad = np.zeros((h, stride - w * 3), np.uint8)
        for fr in frames:
            bgr = fr[::-1, :, ::-1]                    # bottom-up BGR
            yield np.concatenate(
                [bgr.reshape(h, w * 3), pad], axis=1).tobytes()
    return _py_avi(path, n, w, h, fps, stride * h, 24, 0, b"DIB ", gen(),
                   pcm, rate)


def write_avi_i420(path: str, y: np.ndarray, u: np.ndarray, v: np.ndarray,
                   fps: float = 25.0, audio=None,
                   sample_rate: int = 16000) -> str:
    """Mux yuv420p planes (a ``transfer_format='yuv420'`` pipeline's
    output: y [N,H,W], u/v [N,H/2,W/2] uint8) into an 'I420' AVI, a
    straight plane copy.  ``audio`` as in :func:`write_avi_rgb`."""
    y = np.ascontiguousarray(y, np.uint8)
    u = np.ascontiguousarray(u, np.uint8)
    v = np.ascontiguousarray(v, np.uint8)
    n, h, w = y.shape
    if h % 2 or w % 2:
        raise ValueError(f"I420 needs even dimensions, got {h}x{w}")
    pcm, rate = pcm16(audio, sample_rate)
    fourcc = int.from_bytes(b"I420", "little")

    def gen():
        for i in range(n):
            yield y[i].tobytes() + u[i].tobytes() + v[i].tobytes()
    return _py_avi(path, n, w, h, fps, w * h * 3 // 2, 12, fourcc,
                   b"I420", gen(), pcm, rate)
