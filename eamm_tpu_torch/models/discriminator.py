"""Patch discriminator of the GAN fine-tune, with spectral norm (NCHW).

Counterpart of ``eamm_tpu/models/discriminator.py``.  Names are the
reference checkpoint's: ``discs.<scale>.down_blocks.<i>.conv`` (with
spectral norm ``weight_orig`` and the power-iteration vector ``weight_u``),
``...down_blocks.<i>.norm`` (InstanceNorm, affine) and ``discs.<scale>.conv``.

Spectral norm is the JAX module's, not ``nn.utils.spectral_norm``: every
call runs one power iteration in float32 from the stored ``u`` (training
or eval), the gradient flows through the iteration, and the stored ``u``
changes only when the caller asks (``update_spectral_norms``, which the
discriminator step calls with the weights it differentiated, as JAX's
``update_stats=True`` does).  The generator step reads the discriminator
with ``u`` unchanged.
"""
from __future__ import annotations

from typing import Mapping

import torch
import torch.nn as nn
import torch.nn.functional as F

from eamm_tpu_torch.ops.grid import kp2gaussian
from eamm_tpu_torch.ops.warp import avg_pool_2x


class SNConv2d(nn.Module):
    """An unpadded conv whose kernel is divided by its spectral norm (one
    power iteration on the [out, in*kh*kw] matrix) when ``use_sn``."""

    def __init__(self, in_features: int, out_features: int, kernel: int,
                 use_sn: bool = True, eps: float = 1e-12):
        super().__init__()
        w = torch.empty(out_features, in_features, kernel, kernel)
        nn.init.kaiming_uniform_(w, a=5 ** 0.5)        # torch's conv default
        self.use_sn = use_sn
        self.eps = eps
        if use_sn:
            self.weight_orig = nn.Parameter(w)
            self.register_buffer("weight_u", torch.randn(out_features))
        else:
            self.weight = nn.Parameter(w)
        self.bias = nn.Parameter(torch.zeros(out_features))

    def power_iteration(self):
        """(u_new, sigma) from the stored u, in float32 (float64 for
        float64 weights) whatever autocast would choose."""
        w = self.weight_orig
        dt = torch.promote_types(w.dtype, torch.float32)
        with torch.autocast(w.device.type, enabled=False):
            w_mat = w.to(dt).reshape(w.shape[0], -1)
            v = w_mat.t() @ self.weight_u.to(dt)
            v = v / (torch.linalg.vector_norm(v) + self.eps)
            wv = w_mat @ v
            u_new = wv / (torch.linalg.vector_norm(wv) + self.eps)
            return u_new, u_new @ wv

    def kernel(self) -> torch.Tensor:
        if not self.use_sn:
            return self.weight
        _, sigma = self.power_iteration()
        return self.weight_orig / sigma.to(self.weight_orig.dtype)

    @torch.no_grad()
    def update_u(self) -> None:
        if self.use_sn:
            self.weight_u.copy_(self.power_iteration()[0])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = self.kernel()
        return F.conv2d(x, w.to(x.dtype), self.bias.to(x.dtype))


class DownBlock2d(nn.Module):
    """conv 4x4 (no padding) -> [InstanceNorm] -> leaky_relu(0.2) ->
    [2x2 average pool]."""

    def __init__(self, in_features: int, out_features: int, norm: bool,
                 pool: bool, sn: bool):
        super().__init__()
        self.conv = SNConv2d(in_features, out_features, 4, use_sn=sn)
        self.norm = (nn.InstanceNorm2d(out_features, affine=True)
                     if norm else None)
        self.pool = pool

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = self.conv(x)
        if self.norm is not None:
            out = self.norm(out)
        out = F.leaky_relu(out, 0.2)
        if self.pool:
            out = avg_pool_2x(out.permute(0, 2, 3, 1)).permute(0, 3, 1, 2)
        return out


class Discriminator(nn.Module):
    def __init__(self, num_channels: int = 3, block_expansion: int = 64,
                 num_blocks: int = 4, max_features: int = 512,
                 sn: bool = False, use_kp: bool = False, num_kp: int = 10,
                 kp_variance: float = 0.01):
        super().__init__()
        width = [min(max_features, block_expansion * (2 ** (i + 1)))
                 for i in range(num_blocks)]
        cin = num_channels + (num_kp if use_kp else 0)
        self.down_blocks = nn.ModuleList(
            DownBlock2d(cin if i == 0 else width[i - 1], width[i],
                        norm=i != 0, pool=i != num_blocks - 1, sn=sn)
            for i in range(num_blocks))
        self.conv = SNConv2d(width[-1], 1, 1, use_sn=sn)
        self.use_kp = use_kp
        self.kp_variance = kp_variance

    def forward(self, x: torch.Tensor, kp: dict | None = None):
        """x [B, C, H, W] -> (feature maps, prediction map [B, 1, h, w])."""
        if self.use_kp:
            heat = kp2gaussian(kp["value"], x.shape[2:], self.kp_variance)
            x = torch.cat([x, heat.to(x.dtype)], dim=1)
        feature_maps = []
        out = x
        for block in self.down_blocks:
            out = block(out)
            feature_maps.append(out)
        return feature_maps, self.conv(out)


def scale_key(scale) -> str:
    return str(scale).replace(".", "-")


class MultiScaleDiscriminator(nn.Module):
    """One patch discriminator per pyramid scale."""

    def __init__(self, scales=(1,), **kwargs):
        super().__init__()
        self.scales = tuple(scales)
        self.discs = nn.ModuleDict({scale_key(s): Discriminator(**kwargs)
                                    for s in self.scales})

    def forward(self, pyramid: Mapping, kp: dict | None = None) -> dict:
        """pyramid {'prediction_<scale>': [B, C, h, w]} ->
        {'feature_maps_<scale>': [...], 'prediction_map_<scale>': ...}."""
        out = {}
        for s in self.scales:
            feats, pred = self.discs[scale_key(s)](pyramid[f"prediction_{s}"],
                                                   kp)
            out[f"feature_maps_{s}"] = feats
            out[f"prediction_map_{s}"] = pred
        return out

    def update_spectral_norms(self) -> None:
        """Store each conv's next power-iteration vector, from its current
        weights."""
        for m in self.modules():
            if isinstance(m, SNConv2d):
                m.update_u()

    def load_reference(self, state_dict: Mapping) -> None:
        """Load a reference checkpoint's discriminator, whose spectral norm
        also kept ``weight_v`` (``nn.utils.spectral_norm``); the power
        iteration here starts from ``weight_u`` alone."""
        self.load_state_dict({k: v for k, v in state_dict.items()
                              if not k.endswith(".weight_v")})
