"""Training augmentation on the device (part1 subset).

Counterpart of ``eamm_tpu/ops/augment.py``: a batch may carry raw uint8
frames and per-clip augmentation decisions drawn on the host
(``flip_time``, ``flip_h``, ``jitter_factors [B, 4]``); the step turns the
frames into float32 in [0, 1] and applies the flips and the colour jitter
to the ``driving`` stream where the frames are.  The jitter is the host
``ColorJitter.apply_factors``'s: brightness scale, contrast about the
per-frame mean, saturation about ITU-R 601 luma, a YIQ hue rotation, clip
to [0, 1].  The part2 pipeline (``tdrv_*`` keys: the mouth mask,
rotation, perspective) is not ported yet (ROADMAP Queue 1).
"""
from __future__ import annotations

import math

import numpy as np
import torch

_LUMA = (0.299, 0.587, 0.114)
_TO_YIQ = np.array([[0.299, 0.587, 0.114],
                    [0.596, -0.274, -0.322],
                    [0.211, -0.523, 0.312]], np.float64)
_FROM_YIQ = np.linalg.inv(_TO_YIQ)


def _hue_matrix(hshift: torch.Tensor) -> torch.Tensor:
    """[..., 3, 3] RGB-space hue rotation for a shift in turns."""
    theta = 2.0 * math.pi * hshift
    c, s = torch.cos(theta), torch.sin(theta)
    zero, one = torch.zeros_like(c), torch.ones_like(c)
    rot = torch.stack([torch.stack([one, zero, zero], -1),
                       torch.stack([zero, c, -s], -1),
                       torch.stack([zero, s, c], -1)], -2)
    to_yiq = torch.as_tensor(_TO_YIQ, dtype=rot.dtype, device=rot.device)
    from_yiq = torch.as_tensor(_FROM_YIQ, dtype=rot.dtype, device=rot.device)
    return from_yiq @ rot @ to_yiq


def color_jitter(clip: torch.Tensor, b, c, s, hshift) -> torch.Tensor:
    """Jitter [..., T, H, W, 3] frames; the factors broadcast against the
    leading axes (pass [B, 1, 1, 1, 1] for a [B, T, H, W, 3] batch)."""
    x = clip * b
    mean = x.mean(dim=(-3, -2, -1), keepdim=True)          # per frame
    x = (x - mean) * c + mean
    gray = x @ torch.tensor(_LUMA, dtype=x.dtype, device=x.device)
    x = (x - gray[..., None]) * s + gray[..., None]
    h = torch.as_tensor(hshift, dtype=x.dtype, device=x.device)
    m = _hue_matrix(h[..., 0] if h.dim() == x.dim() else h)
    x = torch.einsum("...c,...dc->...d", x, m)
    return x.clamp(0.0, 1.0)


def decode_and_augment(batch: dict) -> dict:
    """uint8 image streams -> float32 in [0, 1]; then ``flip_time`` /
    ``flip_h`` (per-sample flags) reverse the driving clip in time or
    width, and ``jitter_factors`` jitter it.  Returns a new dict without
    the augmentation keys; a batch with none of them passes unchanged."""
    out = dict(batch)
    if any(k.startswith("tdrv_") for k in out):
        raise NotImplementedError("the part2 device augmentation (tdrv_* "
                                  "keys) is not ported yet (ROADMAP Queue 1)")
    for k in ("example_image", "driving", "transformed_driving"):
        if k in out and out[k].dtype == torch.uint8:
            out[k] = out[k].float() * np.float32(1.0 / 255.0)
    ft = out.pop("flip_time", None)
    fh = out.pop("flip_h", None)
    fac = out.pop("jitter_factors", None)
    if ft is not None:
        d = out["driving"]
        flag = ft.reshape((-1,) + (1,) * (d.dim() - 1)) > 0
        out["driving"] = torch.where(flag, d.flip(1), d)
    if fh is not None:
        d = out["driving"]
        flag = fh.reshape((-1,) + (1,) * (d.dim() - 1)) > 0
        out["driving"] = torch.where(flag, d.flip(-2), d)
    if fac is not None:
        d = out["driving"]
        bc = (slice(None),) + (None,) * (d.dim() - 1)
        fac = fac.to(d.dtype)
        out["driving"] = color_jitter(d, fac[:, 0][bc], fac[:, 1][bc],
                                      fac[:, 2][bc], fac[:, 3][bc])
    return out
