"""RGB <-> YUV 4:2:0 conversion, BT.601 full range (JPEG) (PyTorch
counterpart of ``eamm_tpu/ops/colorspace.py``).

The yuv420 delivery path converts each rendered chunk on the device and
copies 12 bits a pixel to the host, half the bytes of uint8 RGB, with the
loss a yuv420p video encoder imposes anyway.  Emotion frames can travel the
other way as one packed uint8 plane array per frame (``pack_yuv420_np`` on
the host, ``unpack_yuv420`` on the device).  Chroma is the mean of each 2x2
block going down and repeated over it going up.
"""
from __future__ import annotations

import numpy as np
import torch

# BT.601 full-range luma weights
_KR, _KG, _KB = 0.299, 0.587, 0.114


def _chroma(r, g, b):
    cb = -0.168736 * r - 0.331264 * g + 0.5 * b      # in [-0.5, 0.5]
    cr = 0.5 * r - 0.418688 * g - 0.081312 * b
    return cb, cr


def rgb_to_yuv420(pred: torch.Tensor):
    """[T, H, W, 3] float RGB in [0, 1] -> (Y [T, H, W], U, V [T, H/2, W/2])
    uint8 on the tensor's device: value x 255 (+ 128 for chroma), rounded
    half to even, clipped to [0, 255]."""
    r, g, b = pred[..., 0], pred[..., 1], pred[..., 2]
    y = _KR * r + _KG * g + _KB * b
    cb, cr = _chroma(r, g, b)
    *lead, H, W = cb.shape
    cb = cb.reshape(*lead, H // 2, 2, W // 2, 2).mean(dim=(-3, -1))
    cr = cr.reshape(*lead, H // 2, 2, W // 2, 2).mean(dim=(-3, -1))

    def q(x, offset=0.0):
        return torch.clamp(torch.round(x * 255.0 + offset), 0, 255).to(
            torch.uint8)

    return q(y), q(cb, 128.0), q(cr, 128.0)


def pack_yuv420_np(frames: np.ndarray) -> np.ndarray:
    """Host: [N, H, W, 3] float RGB in [0, 1] -> one uint8 array
    [N, 3H/2, W]: Y in rows 0 .. H-1, then U beside V in rows H .. 3H/2-1
    (the i420 framing).  The arithmetic of ``rgb_to_yuv420``."""
    f = np.asarray(frames, np.float32)
    r, g, b = f[..., 0], f[..., 1], f[..., 2]
    y = _KR * r + _KG * g + _KB * b
    cb, cr = _chroma(r, g, b)
    N, H, W = y.shape
    cb = cb.reshape(N, H // 2, 2, W // 2, 2).mean(axis=(2, 4))
    cr = cr.reshape(N, H // 2, 2, W // 2, 2).mean(axis=(2, 4))

    def q(x, offset=0.0):
        return np.clip(np.round(x * 255.0 + offset), 0, 255).astype(np.uint8)

    out = np.empty((N, H + H // 2, W), np.uint8)
    out[:, :H] = q(y)
    out[:, H:, :W // 2] = q(cb, 128.0)
    out[:, H:, W // 2:] = q(cr, 128.0)
    return out


def _yuv_to_rgb(y, u, v):
    """Float planes (chroma centred on 0, full resolution) -> the three
    RGB planes."""
    return (y + 1.402 * v,
            y - 0.344136 * u - 0.714136 * v,
            y + 1.772 * u)


def _upsample(c: torch.Tensor) -> torch.Tensor:
    return c.repeat_interleave(2, dim=-2).repeat_interleave(2, dim=-1)


def unpack_yuv420(packed: torch.Tensor) -> torch.Tensor:
    """Device inverse of ``pack_yuv420_np``: uint8 [N, 3H/2, W] -> float32
    RGB [N, H, W, 3] in [0, 1] (clipped to [0, 255], then x 1/255)."""
    Hp, W = packed.shape[-2:]
    H = (Hp * 2) // 3
    y = packed[:, :H].float()
    u = _upsample(packed[:, H:, :W // 2].float() - 128.0)
    v = _upsample(packed[:, H:, W // 2:].float() - 128.0)
    rgb = torch.stack(_yuv_to_rgb(y, u, v), dim=-1)
    return torch.clamp(rgb, 0.0, 255.0) * np.float32(1.0 / 255.0)


def yuv420_to_rgb(y: np.ndarray, u: np.ndarray, v: np.ndarray) -> np.ndarray:
    """Host inverse of ``rgb_to_yuv420``: uint8 planes -> uint8 RGB
    [..., H, W, 3], chroma repeated over its 2x2 block, clipped to
    [0, 255] and truncated."""
    def t(a):
        a = np.ascontiguousarray(a)
        return torch.from_numpy(a if a.flags.writeable else a.copy()).float()

    rgb = torch.stack(_yuv_to_rgb(t(y), _upsample(t(u) - 128.0),
                                  _upsample(t(v) - 128.0)), dim=-1)
    return rgb.clamp_(0, 255).to(torch.uint8).numpy()
