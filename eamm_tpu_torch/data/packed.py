"""Packed decode-free clip storage (the read side, and ``write_pack``).

The port's copy of ``eamm_tpu/data/packed.py``: a ``frames.eammpack`` file
in a clip directory holds its frames as raw uint8 pixels, so loading a
window is a memmap slice, with no PNG decoding.  ``data/datasets.py``
prefers a pack next to the requested PNGs.  Packing a dataset tree
(``pack_clip`` / ``pack_tree``, the JAX CLI's ``preprocess pack``) is not
ported yet (ROADMAP Queue 1); ``write_pack`` writes one file.

``frames.eammpack`` layout (little-endian), one file per clip directory::

    8s    magic  b"EAMMPAK1"
    u32   n, h, w, c
    u32[n]  frame ids (the <id>.png basenames the frames came from)
    u8[n*h*w*c]  frame pixels, HWC, in listed order
"""
from __future__ import annotations

import collections
import os
import struct
import threading

import numpy as np

PACK_NAME = "frames.eammpack"
_MAGIC = b"EAMMPAK1"
_HEADER = struct.Struct("<8s4I")


def write_pack(out_path: str, ids: list[int], frames: np.ndarray) -> None:
    """Write frames [n,h,w,c] uint8 (or float in [0,1]) with their ids."""
    frames = np.asarray(frames)
    if frames.dtype != np.uint8:
        frames = np.clip(np.rint(frames * 255.0), 0, 255).astype(np.uint8)
    n, h, w, c = frames.shape
    if len(ids) != n:
        raise ValueError(f"{len(ids)} ids for {n} frames")
    tmp = out_path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(_HEADER.pack(_MAGIC, n, h, w, c))
        f.write(np.asarray(ids, "<u4").tobytes())
        f.write(np.ascontiguousarray(frames).tobytes())
    os.replace(tmp, out_path)  # atomic: readers never see a partial pack


class _Pack:
    """One opened pack: id→row lookup over a memmapped pixel block."""

    __slots__ = ("pixels", "index", "shape")

    def __init__(self, path: str):
        with open(path, "rb") as f:
            magic, n, h, w, c = _HEADER.unpack(f.read(_HEADER.size))
            if magic != _MAGIC:
                raise IOError(f"{path}: not an eammpack file")
            ids = np.frombuffer(f.read(4 * n), "<u4")
        self.shape = (h, w, c)
        self.index = {int(i): row for row, i in enumerate(ids)}
        self.pixels = np.memmap(
            path, np.uint8, "r", offset=_HEADER.size + 4 * n,
            shape=(n, h, w, c))


class PackCache:
    """Thread-safe LRU of opened packs (memmaps are cheap; the cap only
    bounds file descriptors on huge datasets)."""

    def __init__(self, capacity: int = 256):
        self.capacity = capacity
        self._packs: collections.OrderedDict[str, _Pack] = \
            collections.OrderedDict()
        self._lock = threading.Lock()

    def get(self, path: str) -> _Pack:
        with self._lock:
            pack = self._packs.get(path)
            if pack is not None:
                self._packs.move_to_end(path)
                return pack
        pack = _Pack(path)  # open outside the lock; losing a race is fine
        with self._lock:
            self._packs[path] = pack
            self._packs.move_to_end(path)
            while len(self._packs) > self.capacity:
                self._packs.popitem(last=False)
        return pack


_cache = PackCache()


def find_pack(dirname: str) -> str | None:
    path = os.path.join(dirname, PACK_NAME)
    return path if os.path.exists(path) else None


def read_frames(pack_path: str, ids: list[int],
                dtype=np.float32) -> np.ndarray:
    """[len(ids), h, w, c] frames for the given ids: float32 in [0,1], or
    raw bytes with ``dtype=np.uint8`` (a pure memmap copy — the
    device-augmentation upload format)."""
    pack = _cache.get(pack_path)
    try:
        rows = [pack.index[int(i)] for i in ids]
    except KeyError as e:
        raise IOError(f"{pack_path}: frame id {e} not in pack") from None
    raw = pack.pixels[rows]
    if np.dtype(dtype) == np.uint8:
        return np.asarray(raw)
    # multiply by the reciprocal, as the PNG path's uint8->float convert
    return np.asarray(raw, np.float32) * np.float32(1.0 / 255.0)


def frame_ids(pack_path: str) -> list[int]:
    """The frame ids stored in a pack, ascending."""
    return sorted(_cache.get(pack_path).index)


def frame_size(pack_path: str) -> tuple[int, int]:
    h, w, _c = _cache.get(pack_path).shape
    return h, w
