"""The libpng batch decoder (ctypes) and the uncompressed AVI writers.

``decode_batch(paths, h, w)`` decodes PNGs into one float32 [N, h, w, 3]
array through ``eamm_tpu_torch/native/batch_loader.cc``: libpng on worker
threads, outside the GIL.  At first use the source is compiled with
``g++`` into ``build/native/`` at the repository root (named by a hash of
the source and the flags, as the CUDA kernels are) and loaded with ctypes.
Without ``g++`` or libpng's headers the build fails once, and every call
decodes with imageio where it imports, else with ``decode_zlib``: the
standard library's ``zlib`` and numpy, for the 8-bit grey, grey+alpha,
RGB and RGBA files that are not interlaced, bitwise the native library's
output (its pixel scale and its bilinear resize).  ``route()`` says which
of the three decodes.  This is host code: no decoder touches the device.

The AVI writers (pure Python) are the demo's video output, with the
driving audio muxed in as a 16-bit PCM stream, playable without a codec
or ffmpeg: ``write_avi_rgb`` and ``write_avi_i420`` write byte for byte
the files of ``eamm_tpu/data/native.py``'s writers, which the JAX package
writes with a C++ muxer when it builds and with this muxer otherwise.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import struct
import subprocess
import threading
import zlib
from pathlib import Path

import numpy as np

SOURCE = Path(__file__).resolve().parent.parent / "native" / "batch_loader.cc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
CXX_FLAGS = ("-O3", "-fPIC", "-std=c++17", "-shared")
LIBS = ("-lpng", "-lz", "-lpthread")

_lib = None
_lib_error: str | None = None       # why the library is not there
_lock = threading.Lock()


def _target() -> Path:
    digest = hashlib.sha256(SOURCE.read_bytes() + " ".join(
        CXX_FLAGS + LIBS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"libeamm_decode-{digest}.so"


def _load():
    """The decoder's library, built first if missing; None when it cannot
    be built or loaded (then ``decode_batch`` uses imageio)."""
    global _lib, _lib_error
    with _lock:
        if _lib is not None or _lib_error is not None:
            return _lib
        try:
            target = _target()
            if not target.exists():
                BUILD_DIR.mkdir(parents=True, exist_ok=True)
                tmp = target.with_suffix(f".{os.getpid()}.tmp")
                subprocess.run([os.environ.get("CXX", "g++"), *CXX_FLAGS,
                                "-o", str(tmp), str(SOURCE), *LIBS],
                               check=True, capture_output=True, text=True)
                os.replace(tmp, target)
            lib = ctypes.CDLL(str(target))
            lib.eamm_decode_batch.restype = ctypes.c_int
            lib.eamm_decode_batch.argtypes = [
                ctypes.POINTER(ctypes.c_char_p), ctypes.c_int,
                ctypes.POINTER(ctypes.c_float), ctypes.c_int, ctypes.c_int,
                ctypes.c_int]
            _lib = lib
        except subprocess.CalledProcessError as e:
            _lib_error = (e.stderr or "").strip()[-2000:] or str(e)
        except OSError as e:
            _lib_error = str(e)
        return _lib


def native_available() -> bool:
    """True when ``decode_batch`` decodes with the native library."""
    return _load() is not None


_no_imageio = False             # set once ``import imageio.v2`` failed


def route() -> str:
    """The decoder ``decode_batch`` uses: 'native', else 'imageio' where it
    imports, else 'zlib'.  A failed import of imageio is remembered, so a
    host without it does not search for it again at every batch."""
    global _no_imageio
    if _load() is not None:
        return "native"
    if not _no_imageio:
        try:
            import imageio.v2  # noqa: F401
        except ImportError:
            _no_imageio = True
        else:
            return "imageio"
    return "zlib"


def build_error() -> str | None:
    """Why the native library could not be built or loaded (the
    compiler's last output) and which route decodes instead, or None when
    it is in use."""
    if _load() is None:
        return f"{_lib_error}\n(PNGs decode through the {route()} route)"
    return None


def _decode_imageio(paths: list[str], h: int, w: int) -> np.ndarray:
    import imageio.v2 as imageio

    from eamm_tpu_torch.data.augmentation import _bilinear_sample
    out = np.empty((len(paths), h, w, 3), np.float32)
    for i, p in enumerate(paths):
        img = np.asarray(imageio.imread(p))
        if img.ndim == 2:
            img = np.stack([img] * 3, -1)
        img = img[..., :3].astype(np.float32) / 255.0
        if img.shape[:2] != (h, w):
            ys = (np.arange(h) + 0.5) * img.shape[0] / h - 0.5
            xs = (np.arange(w) + 0.5) * img.shape[1] / w - 0.5
            xg, yg = np.meshgrid(xs, ys)
            img = _bilinear_sample(img, xg, yg, "replicate")
        out[i] = img
    return out


# PNG colour type -> channels, for the 8-bit types decode_zlib reads
_PNG_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}     # grey, RGB, grey+alpha, RGBA
_PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"


def _unfilter(data: bytes, h: int, stride: int, bpp: int) -> np.ndarray:
    """Undo the row filters of ``h`` rows of ``stride`` bytes, ``bpp``
    bytes a pixel -> [h, stride] uint8.  None, Sub and Up are vectorized
    along the row; Average and Paeth read the decoded pixel to their left,
    so they walk the row in order (in Python ints, which here are several
    times faster than numpy calls on a pixel's few channels)."""
    rows = np.frombuffer(data, np.uint8).reshape(h, stride + 1)
    out = np.zeros((h, stride), np.uint8)
    prev = np.zeros(stride, np.int16)
    for y in range(h):
        kind, line = rows[y, 0], rows[y, 1:].astype(np.int16)
        if kind == 0:
            cur = line
        elif kind == 1:
            cur = np.cumsum(line.reshape(-1, bpp), axis=0).reshape(-1) & 255
        elif kind == 2:
            cur = (line + prev) & 255
        elif kind in (3, 4):
            # bytes as Python ints: a pixel's channels are bpp consecutive
            # bytes, each reading the same channel of its left neighbour
            raw, up, cur = line.tolist(), prev.tolist(), [0] * stride
            for i in range(stride):
                a = cur[i - bpp] if i >= bpp else 0
                b = up[i]
                if kind == 3:
                    pred = (a + b) >> 1
                else:
                    c = up[i - bpp] if i >= bpp else 0
                    pa, pb, pc = abs(b - c), abs(a - c), abs(a + b - 2 * c)
                    pred = a if pa <= pb and pa <= pc else (
                        b if pb <= pc else c)
                cur[i] = (raw[i] + pred) & 255
        else:
            raise IOError(f"row {y} has unknown filter type {kind}")
        out[y] = cur
        prev = out[y].astype(np.int16)
    return out


def read_png(path: str) -> np.ndarray:
    """An 8-bit grey, grey+alpha, RGB or RGBA PNG, not interlaced ->
    [H, W, C] uint8 with the file's C channels, by ``zlib`` and numpy;
    raises ``IOError`` naming the file and the property it cannot read
    (16-bit, palette, interlace, a bad signature or stream)."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != _PNG_SIGNATURE:
        raise IOError(f"{path!r}: not a PNG file")
    pos, idat, header = 8, [], None
    while pos + 8 <= len(data):
        n, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + n]
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body[:13])
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
        pos += 12 + n
    if header is None:
        raise IOError(f"{path!r}: no IHDR chunk")
    w, h, depth, color, _, _, interlace = header
    if color not in _PNG_CHANNELS:
        raise IOError(f"{path!r}: colour type {color} "
                      f"({'palette' if color == 3 else 'unknown'}) is not "
                      "read by the zlib route")
    if depth != 8:
        raise IOError(f"{path!r}: bit depth {depth} is not read by the zlib "
                      "route (8-bit only)")
    if interlace:
        raise IOError(f"{path!r}: interlaced (Adam7) is not read by the "
                      "zlib route")
    bpp = _PNG_CHANNELS[color]
    try:
        raw = zlib.decompress(b"".join(idat))
    except zlib.error as e:
        raise IOError(f"{path!r}: bad image data stream ({e})") from e
    if len(raw) != h * (w * bpp + 1):
        raise IOError(f"{path!r}: {len(raw)} bytes of image data for a "
                      f"{w}x{h} image of {bpp} bytes a pixel")
    try:
        return _unfilter(raw, h, w * bpp, bpp).reshape(h, w, bpp)
    except IOError as e:
        raise IOError(f"{path!r}: {e}") from e


def _resize_native(img: np.ndarray, h: int, w: int) -> np.ndarray:
    """``native/batch_loader.cc``'s ``resize_rgb`` in float32, operation
    for operation: [sh, sw, 3] -> [h, w, 3]."""
    sh, sw = img.shape[:2]
    if (sh, sw) == (h, w):
        return img
    f32 = np.float32
    half = f32(0.5)

    def taps(n_out, n_in):
        f = (np.arange(n_out, dtype=f32) + half) * f32(n_in) / f32(n_out) \
            - half
        i0 = np.where(f < 0, 0, f.astype(np.int64))
        i1 = np.minimum(i0 + 1, n_in - 1)
        wt = np.maximum(f - i0.astype(f32), f32(0))
        return i0, i1, wt

    y0, y1, wy = taps(h, sh)
    x0, x1, wx = taps(w, sw)
    wx, wy = wx[None, :, None], wy[:, None, None]
    one = f32(1)
    a = img[y0][:, x0] * (one - wx) + img[y0][:, x1] * wx
    b = img[y1][:, x0] * (one - wx) + img[y1][:, x1] * wx
    return a * (one - wy) + b * wy


def decode_zlib(paths: list[str], h: int, w: int) -> np.ndarray:
    """``decode_batch`` by ``read_png``: grey repeated to RGB, alpha
    dropped, scaled by float32 1/255 and resized as the native library
    does, so that its output is bitwise the library's."""
    out = np.empty((len(paths), h, w, 3), np.float32)
    scale = np.float32(1.0) / np.float32(255.0)
    for i, p in enumerate(paths):
        img = read_png(p)
        img = img[..., :3] if img.shape[2] >= 3 else \
            np.repeat(img[..., :1], 3, axis=2)
        out[i] = _resize_native(img.astype(np.float32) * scale, h, w)
    return out


def decode_batch(paths: list[str], h: int, w: int,
                 n_threads: int = 4) -> np.ndarray:
    """PNGs -> [N, h, w, 3] float32 in [0, 1], each bilinearly resized to
    (h, w) when its size differs; raises IOError naming the first file
    that fails.  The native library decodes where it built, else imageio
    where it imports, else ``decode_zlib`` (``route``)."""
    lib = _load()
    if lib is None:
        if route() == "zlib":
            return decode_zlib(paths, h, w)
        return _decode_imageio(paths, h, w)
    out = np.empty((len(paths), h, w, 3), np.float32)
    names = (ctypes.c_char_p * len(paths))(*[os.fsencode(p) for p in paths])
    rc = lib.eamm_decode_batch(
        names, len(paths), out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        h, w, n_threads)
    if rc != 0:
        raise IOError(f"native decode failed for {paths[rc - 1]!r}")
    return out


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
