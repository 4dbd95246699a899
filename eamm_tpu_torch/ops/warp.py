"""Bilinear resampling primitives on NHWC tensors (PyTorch).

Counterpart of ``eamm_tpu/ops/warp.py``.  ``grid_sample`` is
``torch.nn.functional.grid_sample(mode='bilinear')`` written out as the
four-corner gather, so that the same arithmetic serves as the plain version
of the CUDA warps in ``warp_cuda.py``: coordinates, weights and the sum are
taken in float32 (float64 for float64 inputs, so that finite differences
can check its autodiff) and the result is rounded once to the image dtype.

Grid ``b`` samples image ``b // (B // Bi)``, where ``Bi`` is the image batch
and ``B`` the grid batch: one source can serve many grids without being
repeated in memory.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def _unnormalize(coord: torch.Tensor, size: int,
                 align_corners: bool) -> torch.Tensor:
    """Map [-1, 1] to pixel coordinates."""
    if align_corners:
        return (coord + 1.0) * 0.5 * (size - 1)
    return ((coord + 1.0) * size - 1.0) * 0.5


def _reflect(coord: torch.Tensor, low: float, high: float) -> torch.Tensor:
    """Reflect pixel coordinates into [low / 2, high / 2] (torch's
    ``reflect_coordinates``, which works on twice the coordinate range);
    an empty span maps every coordinate to 0."""
    span = high - low
    if span <= 0:
        return torch.zeros_like(coord)
    c = (coord * 2.0 - low).abs()
    extra = torch.fmod(c, span)
    flips = torch.floor(c / span)
    return torch.where(torch.fmod(flips, 2.0) == 0, extra + low,
                       span - extra + low) * 0.5


def check_shared_batch(image: torch.Tensor, grid: torch.Tensor) -> int:
    """Validate an NHWC image against a [B, Ho, Wo, 2] grid and return the
    number of grids each image serves."""
    if image.dim() != 4 or grid.dim() != 4 or grid.shape[-1] != 2:
        raise ValueError(f"need image [Bi,H,W,C] and grid [B,Ho,Wo,2], got "
                         f"{tuple(image.shape)} and {tuple(grid.shape)}")
    if image.shape[0] == 0 or grid.shape[0] % image.shape[0]:
        raise ValueError(f"image batch {image.shape[0]} must divide grid "
                         f"batch {grid.shape[0]}")
    if image.device != grid.device:
        raise ValueError(f"image on {image.device}, grid on {grid.device}")
    return grid.shape[0] // image.shape[0]


def grid_sample(image: torch.Tensor, grid: torch.Tensor, *,
                padding_mode: str = "zeros",
                align_corners: bool = False) -> torch.Tensor:
    """Bilinear sampling of ``image`` [Bi, H, W, C] at ``grid`` [B, Ho, Wo, 2]
    (last axis (x, y) in [-1, 1]) -> [B, Ho, Wo, C] in the image dtype.

    padding_mode 'zeros' gives out-of-range corners weight 0; 'border'
    clamps the coordinates into the image first; 'reflection' reflects
    them about the image's edges (its pixel centres with
    ``align_corners``, its outer borders without), then clamps."""
    group = check_shared_batch(image, grid)
    Bi, H, W, C = image.shape
    B, Ho, Wo, _ = grid.shape
    acc = torch.promote_types(torch.promote_types(image.dtype, grid.dtype),
                              torch.float32)      # float64 stays float64
    g = grid.to(acc)
    x = _unnormalize(g[..., 0], W, align_corners)
    y = _unnormalize(g[..., 1], H, align_corners)
    if padding_mode == "reflection":
        if align_corners:
            x = _reflect(x, 0.0, 2.0 * (W - 1))
            y = _reflect(y, 0.0, 2.0 * (H - 1))
        else:
            x = _reflect(x, -1.0, 2.0 * W - 1.0)
            y = _reflect(y, -1.0, 2.0 * H - 1.0)
    if padding_mode in ("border", "reflection"):
        x = x.clamp(0, W - 1)
        y = y.clamp(0, H - 1)
    elif padding_mode != "zeros":
        raise ValueError(f"unknown padding_mode {padding_mode!r}")
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    wx1 = x - x0
    wy1 = y - y0
    wx0 = 1.0 - wx1
    wy0 = 1.0 - wy1
    src = image.to(acc).reshape(Bi, H * W, C)
    src_of = torch.arange(B, device=image.device) // group     # [B]

    def corner(cx, cy, w):
        valid = (cx >= 0) & (cx <= W - 1) & (cy >= 0) & (cy <= H - 1)
        w = torch.where(valid, w, torch.zeros_like(w))
        idx = (cy.clamp(0, H - 1) * W + cx.clamp(0, W - 1)).long()
        vals = src[src_of[:, None], idx.reshape(B, -1)]       # [B, P, C]
        return vals.reshape(B, Ho, Wo, C) * w[..., None]

    out = (corner(x0, y0, wx0 * wy0) + corner(x0 + 1, y0, wx1 * wy0)
           + corner(x0, y0 + 1, wx0 * wy1) + corner(x0 + 1, y0 + 1, wx1 * wy1))
    return out.to(image.dtype)


def resize_bilinear(x: torch.Tensor, out_hw: tuple[int, int]) -> torch.Tensor:
    """Half-pixel-centre bilinear resize of [..., H, W, C] (torch
    ``F.interpolate(mode='bilinear', align_corners=False)``, no antialias)."""
    *lead, H, W, C = x.shape
    Ho, Wo = out_hw
    if (Ho, Wo) == (H, W):
        return x
    xb = x.reshape(-1, H, W, C)
    xs = (torch.arange(Wo, dtype=torch.float32, device=x.device) + 0.5) \
        * (W / Wo) - 0.5
    ys = (torch.arange(Ho, dtype=torch.float32, device=x.device) + 0.5) \
        * (H / Ho) - 0.5
    gx = (2.0 * xs + 1.0) / W - 1.0
    gy = (2.0 * ys + 1.0) / H - 1.0
    grid = torch.stack([gx[None, :].expand(Ho, Wo), gy[:, None].expand(Ho, Wo)],
                       dim=-1)
    grid = grid[None].expand(xb.shape[0], Ho, Wo, 2)
    out = grid_sample(xb, grid, padding_mode="border")
    return out.reshape(*lead, Ho, Wo, C)


def upsample_nearest_2x(x: torch.Tensor) -> torch.Tensor:
    """Nearest-neighbour x2 upsample of [B, H, W, C] (each pixel -> 2x2)."""
    return F.interpolate(x.permute(0, 3, 1, 2), scale_factor=2,
                         mode="nearest").permute(0, 2, 3, 1)


def avg_pool_2x(x: torch.Tensor) -> torch.Tensor:
    """2x2 average pool, stride 2, of [B, H, W, C]; an odd trailing row or
    column is dropped."""
    return F.avg_pool2d(x.permute(0, 3, 1, 2), 2).permute(0, 2, 3, 1)
