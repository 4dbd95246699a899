"""Checkpoint-time diagnostic image of the generator (numpy).

Counterpart of ``eamm_tpu/train/visualizer.py``: the source with its
keypoints as dots, the driving frame with its keypoints, the source warped
by the dense deformation, the prediction, the occlusion map, then the K+1
sparse-deformed copies each times its mask, tiled into one image.  It
reads numpy arrays only.  ``save`` writes the PNG itself (zlib and the
standard library), so it needs no image codec.
"""
from __future__ import annotations

import os
import struct
import zlib

import numpy as np


def _colormap(n: int) -> np.ndarray:
    """n distinct RGB colours along a hue sweep (gist_rainbow-like)."""
    colors = []
    for h in np.linspace(0.0, 0.92, n):
        i = int(h * 6) % 6
        f = h * 6 - int(h * 6)
        p, q, t = 0.0, 1 - f, f
        colors.append([(1, t, p), (q, 1, p), (p, 1, t), (p, q, 1), (t, p, 1),
                       (1, p, q)][i])
    return np.asarray(colors)


def draw_kp(image: np.ndarray, kp_value: np.ndarray, kp_size: int = 5,
            colormap: np.ndarray | None = None) -> np.ndarray:
    """Keypoints in [-1, 1] as coloured discs of radius ``kp_size`` on a
    copy of an [H, W, 3] image."""
    img = np.array(image, copy=True)
    H, W = img.shape[:2]
    colors = _colormap(kp_value.shape[0]) if colormap is None else colormap
    spots = (kp_value + 1.0) / 2.0 * np.array([W - 1, H - 1])
    yy, xx = np.mgrid[:H, :W]
    for k, (cx, cy) in enumerate(spots):
        img[(xx - cx) ** 2 + (yy - cy) ** 2 <= kp_size ** 2] = colors[k]
    return img


def make_grid(rows: list[list[np.ndarray]]) -> np.ndarray:
    """[H, W, 3] panels: each inner list side by side, the rows stacked."""
    return np.concatenate([np.concatenate(row, axis=1) for row in rows],
                          axis=0)


def _upscaled(panel: np.ndarray, factor: int, h: int, w: int) -> np.ndarray:
    """Nearest ``factor``x upscale, cut to [h, w]."""
    return np.kron(panel, np.ones((factor, factor, 1)))[:h, :w]


def write_png(path: str, image: np.ndarray) -> None:
    """An [H, W, 3] uint8 image as an 8-bit RGB PNG (no filtering)."""
    h, w, _ = image.shape
    rows = np.concatenate([np.zeros((h, 1), np.uint8),
                           np.ascontiguousarray(image, np.uint8)
                           .reshape(h, w * 3)], axis=1)

    def chunk(kind: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + kind + data
                + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))

    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n"
                + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
                + chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
                + chunk(b"IEND", b""))


class Visualizer:
    def __init__(self, kp_size: int = 5, draw_border: bool = True,
                 colormap: str = "gist_rainbow"):
        self.kp_size = kp_size
        self.draw_border = draw_border

    def visualize(self, driving: np.ndarray, source: np.ndarray,
                  out: dict) -> np.ndarray:
        """The grid, float in [0, 1].  Images are NHWC floats in [0, 1];
        ``out`` holds 'prediction' and 'kp_source' ({'value'}), and may
        hold 'kp_driving', 'deformed', 'occlusion_map' [B, h, w, 1],
        'sparse_deformed' [B, K+1, h, w, 3] with 'mask' [B, h, w, K+1]
        (the low-resolution maps are upscaled 4x)."""
        src = np.asarray(source[0])
        H, W = src.shape[:2]
        panels = [draw_kp(src, np.asarray(out["kp_source"]["value"][0]),
                          self.kp_size)]
        drv = np.asarray(driving[0])
        if "kp_driving" in out:
            drv = draw_kp(drv, np.asarray(out["kp_driving"]["value"][0]),
                          self.kp_size)
        panels.append(drv)
        if "deformed" in out:
            panels.append(np.asarray(out["deformed"][0]))
        panels.append(np.asarray(out["prediction"][0]))
        if "occlusion_map" in out:
            occ = np.asarray(out["occlusion_map"][0])
            occ = np.repeat(occ, 3, axis=-1) if occ.shape[-1] == 1 else occ
            panels.append(_upscaled(occ, 4, H, W))
        rows = [panels]
        if "sparse_deformed" in out:
            sparse = np.asarray(out["sparse_deformed"][0])      # [K+1,h,w,3]
            mask = np.asarray(out["mask"][0])                   # [h,w,K+1]
            row = []
            for k in range(sparse.shape[0]):
                row.append(_upscaled(sparse[k] * mask[..., k:k + 1], 4, H, W))
                if len(row) >= len(panels):
                    rows.append(row)
                    row = []
            if row:
                pad = np.zeros_like(row[0])
                while len(row) < len(rows[-1] if len(rows) > 1 else panels):
                    row.append(pad)
                rows.append(row[:len(panels)])
        width = min(len(r) for r in rows)
        return np.clip(make_grid([r[:width] for r in rows]), 0, 1)

    def save(self, path: str, driving, source, out) -> str:
        """Write the grid to ``path`` as a PNG (values times 255,
        truncated to uint8) and return the path."""
        grid = self.visualize(driving, source, out)
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        write_png(path, (grid * 255).astype(np.uint8))
        return path
