"""Convolution blocks shared by the port's models (NCHW, eval semantics).

Counterpart of ``eamm_tpu/models/blocks.py``.  Module and parameter names
are the reference checkpoints' (``conv``/``norm``, ``encoder.down_blocks``,
``decoder.up_blocks``, ``norm1``/``conv1`` ...), so a reference
``state_dict`` loads as it is.  BatchNorm is ``nn.BatchNorm2d``: in eval it
normalizes with the running statistics, as the JAX module does.  The JAX
package's exact TPU rewrites of some convolutions (``ops/subpixel.py``) are
computed here as the literal convolution.
"""
from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from eamm_tpu_torch.ops.warp import avg_pool_2x, upsample_nearest_2x


def _nchw(fn, x: torch.Tensor) -> torch.Tensor:
    """Apply an NHWC op of ``ops.warp`` to an NCHW tensor (views only)."""
    return fn(x.permute(0, 2, 3, 1)).permute(0, 3, 1, 2)


class ConvBlock(nn.Sequential):
    """conv (no bias) -> BN -> ReLU, as a Sequential so the names are the
    reference's ``<i>.0`` / ``<i>.1``."""

    def __init__(self, in_features: int, out_features: int):
        super().__init__(
            nn.Conv2d(in_features, out_features, 3, padding=1, bias=False),
            nn.BatchNorm2d(out_features), nn.ReLU())


class SameBlock(nn.Module):
    """conv -> BN -> ReLU at the input resolution."""

    def __init__(self, in_features: int, out_features: int, kernel: int = 3,
                 padding: int = 1):
        super().__init__()
        self.conv = nn.Conv2d(in_features, out_features, kernel,
                              padding=padding)
        self.norm = nn.BatchNorm2d(out_features)

    def forward(self, x):
        return F.relu(self.norm(self.conv(x)))


class DownBlock(SameBlock):
    """conv -> BN -> ReLU -> 2x2 average pool."""

    def forward(self, x):
        return _nchw(avg_pool_2x, super().forward(x))


class UpBlock(SameBlock):
    """nearest x2 -> conv -> BN -> ReLU (the literal form)."""

    def forward(self, x):
        return super().forward(_nchw(upsample_nearest_2x, x))


class ResBlock(nn.Module):
    """Pre-activation residual block: x + conv(relu(bn(conv(relu(bn(x))))))."""

    def __init__(self, features: int):
        super().__init__()
        self.norm1 = nn.BatchNorm2d(features)
        self.conv1 = nn.Conv2d(features, features, 3, padding=1)
        self.norm2 = nn.BatchNorm2d(features)
        self.conv2 = nn.Conv2d(features, features, 3, padding=1)

    def forward(self, x):
        out = self.conv1(F.relu(self.norm1(x)))
        return self.conv2(F.relu(self.norm2(out))) + x


def _level(block_expansion: int, max_features: int, i: int) -> int:
    return min(max_features, block_expansion * (2 ** i))


class Encoder(nn.Module):
    """DownBlocks keeping every level's output as a skip."""

    def __init__(self, block_expansion: int, in_features: int,
                 num_blocks: int, max_features: int):
        super().__init__()
        self.down_blocks = nn.ModuleList(
            DownBlock(in_features if i == 0
                      else _level(block_expansion, max_features, i),
                      _level(block_expansion, max_features, i + 1))
            for i in range(num_blocks))

    def forward(self, x):
        outs = [x]
        for block in self.down_blocks:
            outs.append(block(outs[-1]))
        return outs


class Decoder(nn.Module):
    """UpBlocks, each followed by concatenation of the matching skip;
    output channels block_expansion + in_features."""

    def __init__(self, block_expansion: int, in_features: int,
                 num_blocks: int, max_features: int):
        super().__init__()
        self.up_blocks = nn.ModuleList(
            UpBlock((1 if i == num_blocks - 1 else 2)
                    * _level(block_expansion, max_features, i + 1),
                    _level(block_expansion, max_features, i))
            for i in reversed(range(num_blocks)))
        self.out_features = block_expansion + in_features

    def forward(self, skips):
        skips = list(skips)
        out = skips.pop()
        for block in self.up_blocks:
            out = torch.cat([block(out), skips.pop()], dim=1)
        return out


class Hourglass(nn.Module):
    """Encoder + skip decoder."""

    def __init__(self, block_expansion: int, in_features: int,
                 num_blocks: int = 3, max_features: int = 256):
        super().__init__()
        self.encoder = Encoder(block_expansion, in_features, num_blocks,
                               max_features)
        self.decoder = Decoder(block_expansion, in_features, num_blocks,
                               max_features)
        self.out_features = self.decoder.out_features

    def forward(self, x):
        return self.decoder(self.encoder(x))
