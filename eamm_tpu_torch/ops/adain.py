"""Adaptive instance normalization and CORAL colour transfer, NCHW.

Counterpart of ``eamm_tpu/ops/adain.py``: instance statistics are per
sample and channel over (H, W), the variance the biased one.
"""
from __future__ import annotations

import torch


def calc_mean_std(feat: torch.Tensor, eps: float = 1e-5):
    """feat [B, C, H, W] -> (mean, std), each [B, C, 1, 1]."""
    var, mean = torch.var_mean(feat, dim=(2, 3), keepdim=True,
                               correction=0)
    return mean, torch.sqrt(var + eps)


def adaptive_instance_normalization(content: torch.Tensor,
                                    style: torch.Tensor) -> torch.Tensor:
    """``content`` with its instance statistics replaced by ``style``'s."""
    c_mean, c_std = calc_mean_std(content)
    s_mean, s_std = calc_mean_std(style)
    return (content - c_mean) / c_std * s_std + s_mean


def _matrix_sqrt(m: torch.Tensor, inverse: bool) -> torch.Tensor:
    """A symmetric matrix's square root (or inverse square root) through
    its eigendecomposition, eigenvalues clipped at 0 (1e-8 for the
    inverse)."""
    vals, vecs = torch.linalg.eigh(m)
    roots = (vals.clamp_min(1e-8).rsqrt() if inverse
             else vals.clamp_min(0).sqrt())
    return vecs @ torch.diag(roots) @ vecs.t()


def coral(source: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Colour transfer: whiten ``source``'s channel statistics and colour
    it with ``target``'s covariance, mean and std.  source, target
    [H, W, 3] in [0, 1] (images, channels last, as the JAX function)."""
    def normalized(x):
        flat = x.reshape(-1, 3).t()                       # [3, N]
        std, mean = torch.std_mean(flat, dim=1, keepdim=True, correction=0)
        return (flat - mean) / (std + 1e-8), mean, std + 1e-8

    src, _, _ = normalized(source)
    tgt, t_mean, t_std = normalized(target)
    eye = torch.eye(3, dtype=src.dtype, device=src.device)
    cov_s = src @ src.t() + eye
    cov_t = tgt @ tgt.t() + eye
    transfer = (_matrix_sqrt(cov_t, False) @ _matrix_sqrt(cov_s, True)
                @ src)
    return (transfer * t_std + t_mean).t().reshape(source.shape)
