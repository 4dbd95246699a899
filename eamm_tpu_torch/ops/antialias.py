"""Band-limited downsampling (PyTorch counterpart of
``eamm_tpu/ops/antialias.py``): a normalized Gaussian blur with zero padding,
run as two 1-D depthwise convolutions, then a strided slice."""
from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F


@functools.lru_cache(maxsize=None)
def gaussian_kernel_1d(sigma: float = 1.5) -> np.ndarray:
    """Normalized 1-D Gaussian taps of width 2 * round(4 sigma) + 1."""
    ksize = 2 * round(sigma * 4) + 1
    mean = (ksize - 1) / 2.0
    taps = np.exp(-((np.arange(ksize) - mean) ** 2) / (2.0 * sigma ** 2))
    return (taps / taps.sum()).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _taps(sigma: float, dtype: torch.dtype, device: torch.device
          ) -> torch.Tensor:
    """``gaussian_kernel_1d`` on ``device``, uploaded once (an upload from
    pageable memory would wait for the device's queue)."""
    return torch.as_tensor(gaussian_kernel_1d(sigma), dtype=dtype,
                           device=device)


def antialias_downsample(x: torch.Tensor, scale: float,
                         sigma: float = 1.5) -> torch.Tensor:
    """[B, H, W, C] -> [B, H*scale, W*scale, C]; scale 1 is the identity.

    Blur with ``k // 2`` zeros on each side, then keep every
    ``int(1 / scale)``-th pixel."""
    if scale == 1.0:
        return x
    taps = _taps(sigma, x.dtype, x.device)
    k = taps.numel()
    C = x.shape[-1]
    xc = x.permute(0, 3, 1, 2)
    out = F.conv2d(xc, taps.view(1, 1, k, 1).expand(C, 1, k, 1),
                   padding=(k // 2, 0), groups=C)
    out = F.conv2d(out, taps.view(1, 1, 1, k).expand(C, 1, 1, k),
                   padding=(0, k // 2), groups=C)
    step = int(1.0 / scale)
    return out[:, :, ::step, ::step].permute(0, 2, 3, 1)
