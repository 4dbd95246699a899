"""Training augmentation on the device.

Counterpart of ``eamm_tpu/ops/augment.py``: a batch may carry raw uint8
frames and per-clip augmentation decisions drawn on the host
(``flip_time``, ``flip_h``, ``jitter_factors [B, 4]``); the step turns the
frames into float32 in [0, 1] and applies the flips and the colour jitter
to the ``driving`` stream where the frames are.  The jitter is the host
``ColorJitter.apply_factors``'s: brightness scale, contrast about the
per-frame mean, saturation about ITU-R 601 luma, a YIQ hue rotation, clip
to [0, 1].

Part2's MEAD batches may instead carry ``tdrv_*`` decisions, from which
``transformed_driving`` is built here from the clean ``driving`` stream,
in the host pipeline's order: the mouth noise block, the flips, one
rotation per clip (zeros padding), one perspective per frame (border
padding, at a fixed 256x256), the jitter.  The homography warps sample
with ``ops/warp.grid_sample`` at ``align_corners=True``; the JAX package
computes them in XLA too, so the plain function serves on every device.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from eamm_tpu_torch.ops.warp import grid_sample

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
    width, and ``jitter_factors`` jitter it; ``tdrv_*`` keys build
    ``transformed_driving`` (``apply_mead_augmentation``).  Returns a new
    dict without the augmentation keys; a batch with none of them passes
    unchanged."""
    out = dict(batch)
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
    return apply_mead_augmentation(out)


def warp_homography_frames(frames: torch.Tensor, minv: torch.Tensor,
                           padding_mode: str,
                           out_hw: tuple[int, int] | None = None
                           ) -> torch.Tensor:
    """Warp [B, T, H, W, C] frames by per-frame homographies: ``minv``
    [B, T, 3, 3] or [B, 1, 3, 3] maps output pixels to source pixels (the
    host passes ``inv(M)``).  padding_mode 'zeros' or 'border'; the output
    is ``out_hw`` (default the input's size).  The matrices are cast to
    the frames' dtype before the projective divide, as JAX does."""
    B, T, H, W, C = frames.shape
    Ho, Wo = out_hw or (H, W)
    m = minv.expand(B, T, 3, 3).reshape(B * T, 3, 3).to(frames.dtype)
    xs = torch.arange(Wo, dtype=frames.dtype, device=frames.device)
    ys = torch.arange(Ho, dtype=frames.dtype, device=frames.device)
    Y, X = torch.meshgrid(ys, xs, indexing="ij")                # [Ho, Wo]
    pts = torch.stack([X, Y, torch.ones_like(X)]).reshape(3, -1)
    src = torch.einsum("nij,jp->nip", m, pts)                   # [N,3,Ho*Wo]
    sx = src[:, 0] / src[:, 2]
    sy = src[:, 1] / src[:, 2]
    # source pixels -> align_corners=True normalized coordinates
    grid = torch.stack([2.0 * sx / (W - 1) - 1.0, 2.0 * sy / (H - 1) - 1.0],
                       -1).reshape(B * T, Ho, Wo, 2)
    out = grid_sample(frames.reshape(B * T, H, W, C), grid,
                      padding_mode=padding_mode, align_corners=True)
    return out.reshape(B, T, Ho, Wo, C)


def apply_mead_augmentation(out: dict) -> dict:
    """Pop the ``tdrv_*`` decisions of ``out`` and build
    ``out['transformed_driving']`` from ``out['driving']``: mouth noise
    (``tdrv_mouth_noise`` [B, T, h, w, 3] uint8 at ``tdrv_mouth_rect``
    [B, 2] = (y0, x0)), flips, rotation (``tdrv_rot_minv`` [B, 3, 3]),
    perspective (``tdrv_pers_minv`` [B, T, 3, 3]), jitter
    (``tdrv_jitter`` [B, 4]).  Without such keys ``out`` is returned."""
    tdrv = {k: out.pop(k) for k in list(out) if k.startswith("tdrv_")}
    if not tdrv:
        return out
    x = out["driving"]
    noise = tdrv.get("tdrv_mouth_noise")
    if noise is not None:
        x = x.clone()
        nf = noise.to(x.dtype) * np.float32(1.0 / 255.0)
        h, w = nf.shape[2:4]
        H, W = x.shape[2:4]
        # the block is moved inside the frame where it would cross an edge,
        # as lax.dynamic_update_slice clamps its start
        for b, (y0, x0) in enumerate(tdrv["tdrv_mouth_rect"].tolist()):
            y0 = min(max(y0, 0), H - h)
            x0 = min(max(x0, 0), W - w)
            x[b, :, y0:y0 + h, x0:x0 + w] = nf[b]
    ft, fh = tdrv.get("tdrv_flip_time"), tdrv.get("tdrv_flip_h")
    if ft is not None:
        bc = (slice(None),) + (None,) * (x.dim() - 1)
        x = torch.where(ft[bc] > 0, x.flip(1), x)
        x = torch.where(fh[bc] > 0, x.flip(-2), x)
    rot = tdrv.get("tdrv_rot_minv")
    if rot is not None:
        x = warp_homography_frames(x, rot[:, None], "zeros")
    pers = tdrv.get("tdrv_pers_minv")
    if pers is not None:
        # the host (and reference) perspective warp emits 256x256 whatever
        # the input size
        x = warp_homography_frames(x, pers, "border", out_hw=(256, 256))
    fac = tdrv.get("tdrv_jitter")
    if fac is not None:
        bc = (slice(None),) + (None,) * (x.dim() - 1)
        fac = fac.to(x.dtype)
        x = color_jitter(x, fac[:, 0][bc], fac[:, 1][bc], fac[:, 2][bc],
                         fac[:, 3][bc])
    out["transformed_driving"] = x
    return out
