"""Image and video quality metrics of the evaluation modes.

Counterpart of ``eamm_tpu/utils/metrics.py``: per-frame L1, PSNR, SSIM
(Wang et al. 2004: an 11x11 Gaussian window of sigma 1.5, K1 0.01, K2
0.03, dynamic range 1) and AKD (average keypoint distance), over
[T, H, W, C] float clips in [0, 1] on any device.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def psnr(pred: torch.Tensor, target: torch.Tensor,
         max_val: float = 1.0) -> torch.Tensor:
    """Mean PSNR (dB) over the frames of [T, H, W, C] clips."""
    mse = ((pred - target) ** 2).mean(dim=(-3, -2, -1)).clamp_min(1e-12)
    return torch.mean(10.0 * torch.log10(max_val ** 2 / mse))


def _gaussian_window(size: int = 11, sigma: float = 1.5) -> np.ndarray:
    x = np.arange(size, dtype=np.float64) - (size - 1) / 2.0
    g = np.exp(-(x ** 2) / (2 * sigma ** 2))
    return (g / g.sum()).astype(np.float32)


def _window_mean(x: torch.Tensor, win: np.ndarray) -> torch.Tensor:
    """Separable depthwise Gaussian filter of [T, H, W, C], VALID."""
    C = x.shape[-1]
    k = torch.as_tensor(win, dtype=x.dtype, device=x.device)
    y = F.conv2d(x.permute(0, 3, 1, 2), k.view(1, 1, -1, 1).expand(C, 1, -1, 1)
                 .contiguous(), groups=C)
    y = F.conv2d(y, k.view(1, 1, 1, -1).expand(C, 1, 1, -1).contiguous(),
                 groups=C)
    return y.permute(0, 2, 3, 1)


def ssim(pred: torch.Tensor, target: torch.Tensor, max_val: float = 1.0,
         window_size: int = 11, sigma: float = 1.5) -> torch.Tensor:
    """Mean single-scale SSIM over [T, H, W, C] clips."""
    c1 = (0.01 * max_val) ** 2
    c2 = (0.03 * max_val) ** 2
    win = _gaussian_window(window_size, sigma)
    mu_p = _window_mean(pred, win)
    mu_t = _window_mean(target, win)
    mu_pp, mu_tt, mu_pt = mu_p * mu_p, mu_t * mu_t, mu_p * mu_t
    sigma_p = _window_mean(pred * pred, win) - mu_pp
    sigma_t = _window_mean(target * target, win) - mu_tt
    sigma_pt = _window_mean(pred * target, win) - mu_pt
    num = (2 * mu_pt + c1) * (2 * sigma_pt + c2)
    den = (mu_pp + mu_tt + c1) * (sigma_p + sigma_t + c2)
    return torch.mean(num / den)


def average_keypoint_distance(kp_pred: torch.Tensor,
                              kp_target: torch.Tensor) -> torch.Tensor:
    """Mean L2 distance between matching [T, K, 2] keypoints."""
    return torch.linalg.vector_norm(kp_pred - kp_target, dim=-1).mean()


def clip_metrics(pred, target, kp_pred=None, kp_target=None) -> dict:
    """{'l1', 'psnr', 'ssim'} (and 'akd' when both keypoints are given) of
    a clip, as Python floats, computed in float32."""
    pred = torch.as_tensor(pred).float()
    target = torch.as_tensor(target).float()
    out = {"l1": float((pred - target).abs().mean()),
           "psnr": float(psnr(pred, target)),
           "ssim": float(ssim(pred, target))}
    if kp_pred is not None and kp_target is not None:
        out["akd"] = float(average_keypoint_distance(
            torch.as_tensor(kp_pred).float(),
            torch.as_tensor(kp_target).float()))
    return out
