"""StyleGAN2 networks, NCHW: the synthesis network that ``jaco_net='gan'``
decodes ATNet's LSTM output with, and the image networks no entry point
builds (discriminators, encoder, decoder, image generator).

Counterpart of ``eamm_tpu/models/stylegan2.py``, whose design it keeps:

- ``upfirdn2d`` (zero insertion, FIR filter, stride) is one depthwise
  convolution over the zero-inserted, padded input;
- the modulated convolution scales the input, not the weight:
  ``out[b] = demod[b] * conv(x[b] * style[b], scale * W)``, so the whole
  batch runs through one ordinary convolution with one weight;
  ``demod[b, o] = rsqrt(sum_{i,kh,kw} (scale * W[o, i] * style[b, i])^2
  + 1e-8)`` comes from the weight's per-(o, i) sums of squares;
- bias, leaky ReLU (0.2) and the sqrt(2) gain are plain elementwise ops.

EAMM's changes stay: the synthesis network's RGB layers give 35 channels,
its input is the broadcast latent (no learned constant), and it injects no
noise.  ``style=None`` (the decoder's upsampling convolutions) means a
demodulated convolution with no modulation, as in the JAX package.

Parameter names: the synthesis network has the reference checkpoint's
(``style.<i>``, ``conv1``, ``to_rgb1``, ``convs.<i>``, ``to_rgbs.<i>``;
an ``EqualLinear`` weight [out, in], a modulated weight [1, O, I, k, k],
a ``StyledConv``'s ``activate.bias`` [C], a ``ToRGB``'s ``bias``
[1, C, 1, 1]), which the JAX package's ``convert_stylegan2`` reads.  The
other networks have no reference converter; their names are the JAX
modules' (``from_rgb``, ``res<i>``, ``down<i>``, ``up<i>``, ``conv``,
``bias``, ...) with torch layouts (``convert.py``).
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

BLUR = (1, 3, 3, 1)


def fused_leaky_relu(x: torch.Tensor, bias: torch.Tensor,
                     negative_slope: float = 0.2,
                     scale: float = math.sqrt(2.0)) -> torch.Tensor:
    """leaky_relu(x + bias) * scale, ``bias`` [C] on axis 1 of ``x``."""
    b = bias.view(1, -1, *([1] * (x.dim() - 2)))
    return F.leaky_relu(x + b, negative_slope) * scale


def fir_kernel(k=BLUR) -> np.ndarray:
    """The separable FIR taps' outer product, normalized to sum 1."""
    k = np.asarray(k, np.float32)
    k2 = np.outer(k, k)
    return k2 / k2.sum()


def _taps(module: nn.Module, name: str, kernel: np.ndarray) -> None:
    """``kernel`` as a buffer of ``module`` outside its state_dict."""
    module.register_buffer(name, torch.from_numpy(kernel.copy()),
                           persistent=False)


def upfirdn2d(x: torch.Tensor, kernel, up: int = 1, down: int = 1,
              pad: tuple[int, int] = (0, 0)) -> torch.Tensor:
    """x [B, C, H, W]: insert ``up - 1`` zeros after every sample (rows and
    columns), pad ``pad`` = (before, after) on both axes, convolve with
    ``kernel`` [kh, kw] (a true convolution: the taps flipped for
    ``conv2d``'s correlation) per channel, keep every ``down``-th output.
    The modules keep their taps as buffers on the device, so no call
    uploads them."""
    B, C, H, W = x.shape
    if up > 1:
        z = x.new_zeros(B, C, H, up, W, up)
        z[:, :, :, 0, :, 0] = x
        x = z.view(B, C, H * up, W * up)
    x = F.pad(x, (pad[0], pad[1], pad[0], pad[1]))
    k = torch.as_tensor(kernel, dtype=x.dtype, device=x.device).flip(0, 1)
    weight = k.expand(C, 1, *k.shape)
    return F.conv2d(x, weight, stride=down, groups=C)


class PixelNorm(nn.Module):
    """x * rsqrt(mean(x^2) + 1e-8) over the features."""

    def forward(self, x):
        return x * torch.rsqrt(x.square().mean(dim=1, keepdim=True) + 1e-8)


class EqualLinear(nn.Module):
    """Equalized-learning-rate dense layer: weight N(0, 1) / lr_mul, used
    as weight * lr_mul / sqrt(in); bias * lr_mul."""

    def __init__(self, in_dim: int, out_dim: int, lr_mul: float = 1.0,
                 bias_init: float = 0.0, activation: bool = False):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(out_dim, in_dim))
        self.bias = nn.Parameter(torch.empty(out_dim))
        self.lr_mul, self.bias_init = lr_mul, bias_init
        self.scale = lr_mul / math.sqrt(in_dim)
        self.activation = activation
        self.draw(None)

    def draw(self, generator: torch.Generator | None) -> None:
        """The JAX package's initialization, from ``generator``."""
        with torch.no_grad():
            self.weight.normal_(generator=generator).div_(self.lr_mul)
            self.bias.fill_(self.bias_init)

    def forward(self, x):
        out = F.linear(x, self.weight * self.scale)
        if self.activation:
            return fused_leaky_relu(out, self.bias * self.lr_mul)
        return out + self.bias * self.lr_mul


class ModulatedConv(nn.Module):
    """Style-modulated convolution, demodulated unless ``demodulate`` is
    False; ``upsample`` makes it a stride-2 transposed convolution followed
    by the blur.  ``style_dim=None``: no modulation (style 1 everywhere)."""

    def __init__(self, in_channels: int, out_channels: int, kernel: int,
                 style_dim: int | None = 256, demodulate: bool = True,
                 upsample: bool = False, blur_kernel=BLUR):
        super().__init__()
        self.weight = nn.Parameter(
            torch.empty(1, out_channels, in_channels, kernel, kernel))
        self.modulation = (EqualLinear(style_dim, in_channels, bias_init=1.0)
                           if style_dim is not None else None)
        self.scale = 1.0 / math.sqrt(in_channels * kernel * kernel)
        self.kernel, self.demodulate, self.upsample = kernel, demodulate, \
            upsample
        if upsample:
            _taps(self, "blur", fir_kernel(blur_kernel) * 4.0)
            p = len(blur_kernel) - 2 - (kernel - 1)
            self.blur_pad = ((p + 1) // 2 + 1, p // 2 + 1)
        self.draw(None)

    def draw(self, generator: torch.Generator | None) -> None:
        with torch.no_grad():
            self.weight.normal_(generator=generator)

    def forward(self, x, style):
        w = self.weight[0] * self.scale                        # [O, I, k, k]
        if self.modulation is None:
            s = x.new_ones(x.shape[0], x.shape[1])
        else:
            s = self.modulation(style)                         # [B, I]
        xs = x * s[:, :, None, None]
        if self.upsample:
            out = F.conv_transpose2d(xs, w.transpose(0, 1), stride=2)
        else:
            out = F.conv2d(xs, w, padding=self.kernel // 2)
        if self.demodulate:
            w2 = w.square().sum(dim=(2, 3))                    # [O, I]
            demod = torch.rsqrt(s.square() @ w2.t() + 1e-8)    # [B, O]
            out = out * demod[:, :, None, None]
        if self.upsample:
            out = upfirdn2d(out, self.blur, pad=self.blur_pad)
        return out


class FusedLeakyReLU(nn.Module):
    """A bias [C], then leaky ReLU and the sqrt(2) gain."""

    def __init__(self, channels: int):
        super().__init__()
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x):
        return fused_leaky_relu(x, self.bias)


class StyledConv(nn.Module):
    """Modulated convolution + fused bias and leaky ReLU (no noise)."""

    def __init__(self, in_channels: int, out_channels: int, kernel: int = 3,
                 style_dim: int | None = 256, upsample: bool = False):
        super().__init__()
        self.conv = ModulatedConv(in_channels, out_channels, kernel,
                                  style_dim, upsample=upsample)
        self.activate = FusedLeakyReLU(out_channels)

    def forward(self, x, style):
        return self.activate(self.conv(x, style))


class ToRGB(nn.Module):
    """1x1 modulated convolution (not demodulated) to the output channels,
    plus a bias, plus the previous output upsampled 2x through the blur."""

    def __init__(self, in_channels: int, out_channels: int = 35,
                 style_dim: int = 256):
        super().__init__()
        self.conv = ModulatedConv(in_channels, out_channels, 1, style_dim,
                                  demodulate=False)
        self.bias = nn.Parameter(torch.zeros(1, out_channels, 1, 1))
        _taps(self, "skip_kernel", fir_kernel() * 4.0)
        p = len(BLUR) - 2
        self.skip_pad = ((p + 1) // 2 + 1, p // 2)

    def forward(self, x, style, skip=None):
        out = self.conv(x, style) + self.bias
        if skip is not None:
            out = out + upfirdn2d(skip, self.skip_kernel, up=2,
                                  pad=self.skip_pad)
        return out


class SynthesisGenerator(nn.Module):
    """Style MLP + synthesis network: style [B, style_dim] ->
    [B, out_channels, size, size]."""

    def __init__(self, size: int = 64, style_dim: int = 256, n_mlp: int = 8,
                 out_channels: int = 35, channel_multiplier: int = 1):
        super().__init__()
        channels = {4: 256, 8: 256, 16: 128, 32: 64,
                    64: 32 * channel_multiplier,
                    128: 16 * channel_multiplier,
                    256: 8 * channel_multiplier}
        self.style_dim = style_dim
        self.style = nn.Sequential(PixelNorm(), *(
            EqualLinear(style_dim, style_dim, lr_mul=0.01, activation=True)
            for _ in range(n_mlp)))
        self.conv1 = StyledConv(style_dim, channels[4], 3, style_dim)
        self.to_rgb1 = ToRGB(channels[4], out_channels, style_dim)
        self.convs, self.to_rgbs = nn.ModuleList(), nn.ModuleList()
        in_ch = channels[4]
        for res in range(3, int(math.log2(size)) + 1):
            ch = channels[2 ** res]
            self.convs.append(StyledConv(in_ch, ch, 3, style_dim,
                                         upsample=True))
            self.convs.append(StyledConv(ch, ch, 3, style_dim))
            self.to_rgbs.append(ToRGB(ch, out_channels, style_dim))
            in_ch = ch

    def forward(self, style: torch.Tensor) -> torch.Tensor:
        s = self.style(style)
        out = s[:, :, None, None].expand(-1, -1, 4, 4)
        out = self.conv1(out, s)
        skip = self.to_rgb1(out, s)
        for i, to_rgb in enumerate(self.to_rgbs):
            out = self.convs[2 * i + 1](self.convs[2 * i](out, s), s)
            skip = to_rgb(out, s, skip)
        return skip


def draw_parameters(module: nn.Module, generator: torch.Generator) -> None:
    """Draw every StyleGAN2 layer's weights of ``module`` from
    ``generator`` as the JAX package initializes them (biases as
    constructed)."""
    for m in module.modules():
        if isinstance(m, (EqualLinear, ModulatedConv, EqualConv)):
            m.draw(generator)


# ----------------------------------------------------------------------
# The image networks: no entry point builds them.


class EqualConv(nn.Module):
    """Equalized-learning-rate convolution: weight N(0, 1) [O, I, k, k],
    used as weight / sqrt(I k k)."""

    def __init__(self, in_channels: int, out_channels: int, kernel: int,
                 stride: int = 1, padding: int = 0, use_bias: bool = True):
        super().__init__()
        self.weight = nn.Parameter(
            torch.empty(out_channels, in_channels, kernel, kernel))
        self.bias = (nn.Parameter(torch.zeros(out_channels)) if use_bias
                     else None)
        self.scale = 1.0 / math.sqrt(in_channels * kernel * kernel)
        self.stride, self.padding = stride, padding
        self.draw(None)

    def draw(self, generator: torch.Generator | None) -> None:
        with torch.no_grad():
            self.weight.normal_(generator=generator)

    def forward(self, x):
        return F.conv2d(x, self.weight * self.scale, self.bias, self.stride,
                        self.padding)


class ConvLayer(nn.Module):
    """(Blur and stride 2 when ``downsample``) equalized convolution, then
    the fused bias and leaky ReLU when ``activate``."""

    def __init__(self, in_channels: int, out_channels: int, kernel: int,
                 downsample: bool = False, use_bias: bool = True,
                 activate: bool = True, blur_kernel=BLUR):
        super().__init__()
        self.downsample = downsample
        if downsample:
            p = (len(blur_kernel) - 2) + (kernel - 1)
            _taps(self, "blur", fir_kernel(blur_kernel))
            self.blur_pad = ((p + 1) // 2, p // 2)
            stride, padding = 2, 0
        else:
            stride, padding = 1, kernel // 2
        self.conv = EqualConv(in_channels, out_channels, kernel, stride,
                              padding, use_bias=use_bias and not activate)
        self.activate = activate
        self.bias = (nn.Parameter(torch.zeros(out_channels))
                     if activate and use_bias else None)

    def forward(self, x):
        if self.downsample:
            x = upfirdn2d(x, self.blur, pad=self.blur_pad)
        out = self.conv(x)
        if self.activate:
            bias = (self.bias if self.bias is not None
                    else out.new_zeros(out.shape[1]))
            out = fused_leaky_relu(out, bias)
        return out


class DResBlock(nn.Module):
    """Residual block: (conv 3x3, conv 3x3 (downsampling)) + skip (1x1,
    downsampling, when the shape changes), over sqrt(skip_gain^2 + 1)."""

    def __init__(self, in_channels: int, out_channels: int,
                 downsample: bool = True, skip_gain: float = 1.0,
                 blur_kernel=BLUR):
        super().__init__()
        self.conv1 = ConvLayer(in_channels, in_channels, 3)
        self.conv2 = ConvLayer(in_channels, out_channels, 3,
                               downsample=downsample, blur_kernel=blur_kernel)
        self.skip = (ConvLayer(in_channels, out_channels, 1,
                               downsample=downsample, activate=False,
                               use_bias=False)
                     if in_channels != out_channels or downsample else None)
        self.skip_gain = skip_gain

    def forward(self, x):
        out = self.conv2(self.conv1(x))
        skip = x if self.skip is None else self.skip(x)
        return (out * self.skip_gain + skip) / math.sqrt(
            self.skip_gain ** 2 + 1.0)


def _disc_channels(multiplier: float) -> dict:
    return {4: min(384, int(4096 * multiplier)),
            8: min(384, int(2048 * multiplier)),
            16: min(384, int(1024 * multiplier)),
            32: min(384, int(512 * multiplier)),
            64: int(256 * multiplier), 128: int(128 * multiplier),
            256: int(64 * multiplier), 512: int(32 * multiplier),
            1024: int(16 * multiplier)}


class StyleGAN2Discriminator(nn.Module):
    """variant 'global' (a 4x4 map -> one logit per image), 'patch' (8x8
    logits) or 'smallpatch' (16x16); [B, C, size, size] in."""

    def __init__(self, size: int = 256, ndf: int = 64,
                 variant: str = "global", in_channels: int = 3):
        super().__init__()
        channels = _disc_channels(ndf / 64)
        self.variant = variant
        final = {"global": 2, "patch": 3, "smallpatch": 4}[variant]
        self.from_rgb = ConvLayer(in_channels, channels[size], 1)
        self.blocks = []
        ch = channels[size]
        for i in range(int(math.log2(size)), final, -1):
            self.add_module(f"res{i}", DResBlock(ch, channels[2 ** (i - 1)]))
            self.blocks.append(f"res{i}")
            ch = channels[2 ** (i - 1)]
        self.final_conv = ConvLayer(ch, channels[4], 3)
        if variant == "global":
            self.final_dense0 = EqualLinear(channels[4] * 16, channels[4],
                                            activation=True)
            self.final_dense1 = EqualLinear(channels[4], 1)
        else:
            self.final_linear = ConvLayer(channels[4], 1, 3, use_bias=False,
                                          activate=False)

    def forward(self, x):
        out = self.from_rgb(x)
        for name in self.blocks:
            out = getattr(self, name)(out)
        out = self.final_conv(out)
        if self.variant != "global":
            return self.final_linear(out)
        return self.final_dense1(self.final_dense0(out.flatten(1)))


class TileStyleGAN2Discriminator(nn.Module):
    """Scores every patch_size^2 tile of the input (row-major tiles per
    image) with one discriminator."""

    def __init__(self, patch_size: int = 64, ndf: int = 64,
                 variant: str = "global", in_channels: int = 3):
        super().__init__()
        self.patch_size = patch_size
        self.discriminator = StyleGAN2Discriminator(patch_size, ndf, variant,
                                                    in_channels)

    def forward(self, x):
        B, C, H, W = x.shape
        s = self.patch_size
        tiles = (x.reshape(B, C, H // s, s, W // s, s)
                 .permute(0, 2, 4, 1, 3, 5).reshape(-1, C, s, s))
        return self.discriminator(tiles)


def _gen_channels(multiplier: float) -> dict:
    return {4: min(512, int(round(4096 * multiplier))),
            8: min(512, int(round(2048 * multiplier))),
            16: min(512, int(round(1024 * multiplier))),
            32: min(512, int(round(512 * multiplier))),
            64: int(round(256 * multiplier)),
            128: int(round(128 * multiplier)),
            256: int(round(64 * multiplier)),
            512: int(round(32 * multiplier)),
            1024: int(round(16 * multiplier))}


class StyleGAN2Encoder(nn.Module):
    """From-RGB, ``num_downsampling`` downsampling residual blocks, then
    ``n_blocks // 2`` residual blocks.  ``layers`` picks the features to
    return with ``get_features``: 0 the input, 1 the from-RGB output, then
    one index per block, -1 the last."""

    def __init__(self, size: int = 256, ngf: int = 64, n_blocks: int = 6,
                 num_downsampling: int = 1, in_channels: int = 3):
        super().__init__()
        channels = _gen_channels(ngf / 32)
        self.from_rgb = ConvLayer(in_channels, channels[size], 1)
        self.blocks = []
        cur = size
        for i in range(num_downsampling):
            self.add_module(f"down{i}", DResBlock(channels[cur],
                                                  channels[cur // 2]))
            self.blocks.append(f"down{i}")
            cur //= 2
        for i in range(n_blocks // 2):
            self.add_module(f"res{i}", DResBlock(channels[cur], channels[cur],
                                                 downsample=False))
            self.blocks.append(f"res{i}")
        self.out_channels = channels[cur]

    def forward(self, x, layers=(), get_features: bool = False):
        layers = list(layers)
        feats = [x] if 0 in layers else []
        out = self.from_rgb(x)
        if 1 in layers:
            feats.append(out)
        for idx, name in enumerate(self.blocks, start=2):
            out = getattr(self, name)(out)
            if idx in layers:
                feats.append(out)
        if -1 in layers:
            feats.append(out)
        return (out, feats) if get_features else out


class StyleGAN2Decoder(nn.Module):
    """``n_blocks // 2`` residual blocks, ``num_downsampling`` upsampling
    convolutions without style, a 1x1 convolution to RGB."""

    def __init__(self, size: int = 256, ngf: int = 64, n_blocks: int = 6,
                 num_downsampling: int = 1):
        super().__init__()
        channels = _gen_channels(ngf / 32)
        cur = size // (2 ** num_downsampling)
        self.blocks = []
        for i in range(n_blocks // 2):
            self.add_module(f"res{i}", DResBlock(channels[cur], channels[cur],
                                                 downsample=False))
            self.blocks.append(f"res{i}")
        ch = channels[cur]
        for i in range(num_downsampling):
            self.add_module(f"up{i}", StyledConv(ch, channels[cur * 2], 3,
                                                 style_dim=None,
                                                 upsample=True))
            self.blocks.append(f"up{i}")
            ch, cur = channels[cur * 2], cur * 2
        self.to_rgb = ConvLayer(ch, 3, 1)

    def forward(self, x):
        out = x
        for name in self.blocks:
            block = getattr(self, name)
            out = block(out, None) if name.startswith("up") else block(out)
        return self.to_rgb(out)


class StyleGAN2ImageGenerator(nn.Module):
    """Encoder + decoder image-to-image generator."""

    def __init__(self, size: int = 256, ngf: int = 64, n_blocks: int = 6,
                 num_downsampling: int = 1):
        super().__init__()
        self.encoder = StyleGAN2Encoder(size, ngf, n_blocks, num_downsampling)
        self.decoder = StyleGAN2Decoder(size, ngf, n_blocks, num_downsampling)

    def forward(self, x, layers=(), encode_only: bool = False):
        feat, feats = self.encoder(x, layers, get_features=True)
        if encode_only:
            return feats
        fake = self.decoder(feat)
        return (fake, feats) if layers else fake
