"""Coordinate grids and keypoint <-> heatmap transforms (PyTorch).

Counterpart of ``eamm_tpu/ops/grid.py``: an align-corners [-1, 1]^2 grid
whose last axis is (x, y), the Gaussian stamp of a keypoint on it, and the
soft-argmax that reads a keypoint back out of a normalized heatmap.
"""
from __future__ import annotations

import torch


def make_coordinate_grid(h: int, w: int, dtype=torch.float32,
                         device=None) -> torch.Tensor:
    """[h, w, 2] mesh in [-1, 1]^2, channel order (x, y); pixel i of an
    N-pixel axis sits at 2 i / (N - 1) - 1."""
    x = 2.0 * (torch.arange(w, dtype=dtype, device=device) / (w - 1)) - 1.0
    y = 2.0 * (torch.arange(h, dtype=dtype, device=device) / (h - 1)) - 1.0
    return torch.stack([x[None, :].expand(h, w), y[:, None].expand(h, w)],
                       dim=-1)


def kp2gaussian(kp_value: torch.Tensor, spatial_size: tuple[int, int],
                kp_variance: float) -> torch.Tensor:
    """[..., K, 2] keypoints -> [..., K, h, w] isotropic Gaussians
    exp(-0.5 ||z - mu||^2 / var)."""
    h, w = spatial_size
    grid = make_coordinate_grid(h, w, kp_value.dtype, kp_value.device)
    diff = grid - kp_value[..., None, None, :]
    return torch.exp(-0.5 * (diff * diff).sum(-1) / kp_variance)


def heatmap_softmax(prediction: torch.Tensor,
                    temperature: float) -> torch.Tensor:
    """Softmax over the last two axes of [..., K, h, w] at ``temperature``."""
    flat = prediction.flatten(-2)
    return torch.softmax(flat / temperature, dim=-1).view(prediction.shape)


def gaussian2kp(heatmap: torch.Tensor) -> torch.Tensor:
    """Expected (x, y) under a normalized [..., K, h, w] heatmap -> [..., K, 2]."""
    h, w = heatmap.shape[-2:]
    grid = make_coordinate_grid(h, w, heatmap.dtype, heatmap.device)
    return (heatmap[..., None] * grid).sum(dim=(-3, -2))
