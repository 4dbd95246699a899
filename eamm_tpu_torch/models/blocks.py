"""Convolution blocks shared by the port's models (NCHW, eval semantics).

Counterpart of ``eamm_tpu/models/blocks.py``.  Module and parameter names
are the reference checkpoints' (``conv``/``norm``, ``encoder.down_blocks``,
``decoder.up_blocks``, ``norm1``/``conv1`` ...), so a reference
``state_dict`` loads as it is.  BatchNorm is ``nn.BatchNorm2d``: in eval it
normalizes with the running statistics, as the JAX module does.  In eval,
``UpBlock`` computes its upsample and conv in the JAX package's folded form
(``ops/subpixel.py``) from weights folded once per load (``FoldedWeights``);
training keeps the literal form, since BatchNorm's batch statistics are
taken at the doubled resolution.
"""
from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from eamm_tpu_torch.ops.subpixel import (fold_upsample_kernel_d2s,
                                         upsample_conv3x3_d2s)
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


class FoldedWeights:
    """Mixin of a module whose eval form reads weights folded from its own
    (``ops/subpixel.py``).  ``_fold()`` gives {buffer name: tensor} from the
    current weights, ``_fold_sources()`` the parameters it reads.  The
    buffers are not persistent (the state_dict keeps the reference's names
    alone) and are made at the first eval call, then made again whenever a
    parameter they come from has changed (``load_state_dict``, an in-place
    edit, ``.to``): once per load of the weights, never per call.  While
    ``torch.export`` traces, they are read as they stand, so the exporter
    calls ``refold`` first and passes them in with the weights."""

    def _fold(self) -> dict:
        raise NotImplementedError

    def _fold_sources(self) -> list:
        raise NotImplementedError

    def _fold_stamp(self) -> tuple:
        return tuple((p.data_ptr(), p._version, p.dtype, p.device)
                     for p in self._fold_sources())

    def refold(self) -> None:
        with torch.no_grad():
            for name, t in self._fold().items():
                self.register_buffer(name, t, persistent=False)
        self._fold_key = self._fold_stamp()

    def folded(self, *names: str) -> tuple:
        """The folded buffers ``names``, made again first if stale."""
        if not torch.compiler.is_compiling() and \
                getattr(self, "_fold_key", None) != self._fold_stamp():
            self.refold()
        return tuple(getattr(self, n) for n in names)


class UpBlock(FoldedWeights, SameBlock):
    """nearest x2 -> conv -> BN -> ReLU.

    In eval the upsample and conv run as one 3x3 conv at the input
    resolution with 4x the output channels and a depth-to-space
    (``upsample_conv3x3_d2s``, the JAX package's eval form), the bias
    folded into the conv: on an NVIDIA H100 80GB HBM3 at 700 W, 34.56 ms
    of a neutral 10 s request's UpBlocks against the literal form's 44.30
    (``chip_profile.py`` ``conv_forms``).  In training, the literal form."""

    def _fold_sources(self) -> list:
        return [self.conv.weight, self.conv.bias]

    def _fold(self) -> dict:
        w = self.conv.weight          # tap sums in float32, rounded once
        return {"d2s_weight": fold_upsample_kernel_d2s(w.float()).to(w.dtype),
                "d2s_bias": self.conv.bias.repeat_interleave(4)}

    def literal(self, x):
        return super().forward(_nchw(upsample_nearest_2x, x))

    def d2s(self, x):
        w, b = self.folded("d2s_weight", "d2s_bias")
        return F.relu(self.norm(upsample_conv3x3_d2s(x, w, b, folded=True)))

    def forward(self, x):
        if self.training:
            return self.literal(x)
        return self.d2s(x)


def refold_all(module: nn.Module) -> None:
    """Make every folded buffer of ``module`` from its current weights (the
    exporter's first step)."""
    for m in module.modules():
        if isinstance(m, FoldedWeights):
            m.refold()


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
