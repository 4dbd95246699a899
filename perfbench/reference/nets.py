"""Plain PyTorch reference of the networks EAMM renders and trains with, in
the reference's layer names (First Order Motion Model's keypoint detector,
dense motion network and occlusion-aware generator; EAMM's ATNet with its
deconvolution decoder or StyleGAN2's synthesis network; VGG19's features),
so that one set of state dicts loads here and into the program.

Written for clarity over speed: every upsample and every 7x7 head is the
literal layer, the warps are ``F.grid_sample``, StyleGAN2's modulated
convolutions are its non-fused form, and nothing is folded, cached or
fused.  Nothing here imports the program under test.
``BatchNorm2d`` layers follow ``train()``/``eval()``; ``batch_statistics``
normalizes a frozen model with the batch's statistics and leaves its
running statistics as they are, as the reference's frozen detector does.
"""
from __future__ import annotations

import contextlib
import math

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from perfbench.reference import ops


@contextlib.contextmanager
def batch_statistics(model: nn.Module):
    """Train-mode BatchNorm with no running statistics for the block."""
    saved = []
    for m in model.modules():
        if isinstance(m, nn.BatchNorm2d):
            saved.append((m, m.running_mean, m.running_var,
                          m.num_batches_tracked))
            m.running_mean = m.running_var = m.num_batches_tracked = None
    was = model.training
    model.train()
    try:
        yield model
    finally:
        for m, mean, var, count in saved:
            m.running_mean, m.running_var, m.num_batches_tracked = \
                mean, var, count
        model.train(was)


# ---------------------------------------------------------------- blocks

class SameBlock(nn.Module):
    def __init__(self, cin, cout, kernel=3, padding=1):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, kernel, padding=padding)
        self.norm = nn.BatchNorm2d(cout)

    def forward(self, x):
        return F.relu(self.norm(self.conv(x)))


class DownBlock(SameBlock):
    def forward(self, x):
        return F.avg_pool2d(super().forward(x), 2)


class UpBlock(SameBlock):
    def forward(self, x):
        return super().forward(F.interpolate(x, scale_factor=2,
                                             mode="nearest"))


def conv_block(cin, cout):
    return nn.Sequential(nn.Conv2d(cin, cout, 3, padding=1, bias=False),
                         nn.BatchNorm2d(cout), nn.ReLU())


class ResBlock(nn.Module):
    def __init__(self, c):
        super().__init__()
        self.norm1 = nn.BatchNorm2d(c)
        self.conv1 = nn.Conv2d(c, c, 3, padding=1)
        self.norm2 = nn.BatchNorm2d(c)
        self.conv2 = nn.Conv2d(c, c, 3, padding=1)

    def forward(self, x):
        h = self.conv1(F.relu(self.norm1(x)))
        return x + self.conv2(F.relu(self.norm2(h)))


def _width(expansion, max_features, i):
    return min(max_features, expansion * 2 ** i)


class Encoder(nn.Module):
    def __init__(self, expansion, cin, blocks, max_features):
        super().__init__()
        self.down_blocks = nn.ModuleList(
            DownBlock(cin if i == 0 else _width(expansion, max_features, i),
                      _width(expansion, max_features, i + 1))
            for i in range(blocks))

    def forward(self, x):
        outs = [x]
        for block in self.down_blocks:
            outs.append(block(outs[-1]))
        return outs


class Decoder(nn.Module):
    def __init__(self, expansion, cin, blocks, max_features):
        super().__init__()
        self.up_blocks = nn.ModuleList(
            UpBlock((1 if i == blocks - 1 else 2)
                    * _width(expansion, max_features, i + 1),
                    _width(expansion, max_features, i))
            for i in reversed(range(blocks)))
        self.out_features = expansion + cin

    def forward(self, skips):
        out = skips[-1]
        for block, skip in zip(self.up_blocks, reversed(skips[:-1])):
            out = torch.cat([block(out), skip], 1)
        return out


class Hourglass(nn.Module):
    def __init__(self, expansion, cin, blocks, max_features):
        super().__init__()
        self.encoder = Encoder(expansion, cin, blocks, max_features)
        self.decoder = Decoder(expansion, cin, blocks, max_features)
        self.out_features = self.decoder.out_features

    def forward(self, x):
        return self.decoder(self.encoder(x))


# ------------------------------------------------------------- keypoints

class KPDetector(nn.Module):
    """Image -> keypoints: blur x scale -> hourglass -> two 7x7 heads."""

    def __init__(self, num_kp, block_expansion, max_features, num_blocks,
                 temperature, scale_factor, num_channels=3):
        super().__init__()
        self.predictor = Hourglass(block_expansion, num_channels, num_blocks,
                                   max_features)
        self.kp = nn.Conv2d(self.predictor.out_features, num_kp, 7)
        self.jacobian = nn.Conv2d(self.predictor.out_features, 4 * num_kp, 7)
        self.temperature, self.scale_factor = temperature, scale_factor

    def forward(self, image):
        fm = self.predictor(ops.blur_downsample(image, self.scale_factor))
        return ops.soft_keypoints(self.kp(fm), self.jacobian(fm),
                                  self.temperature)


class KPDetectorA(nn.Module):
    """ATNet's 35-channel map -> keypoints: the two 7x7 heads alone."""

    def __init__(self, num_kp=10, temperature=0.1, in_features=35):
        super().__init__()
        self.kp = nn.Conv2d(in_features, num_kp, 7)
        self.jacobian = nn.Conv2d(in_features, 4 * num_kp, 7)
        self.temperature = temperature

    def forward(self, maps):
        return ops.soft_keypoints(self.kp(maps), self.jacobian(maps),
                                  self.temperature)


# ------------------------------------------------------------- generator

class DenseMotionNetwork(nn.Module):
    def __init__(self, num_kp, num_channels, block_expansion, max_features,
                 num_blocks, scale_factor, kp_variance=0.01):
        super().__init__()
        self.hourglass = Hourglass(block_expansion,
                                   (num_kp + 1) * (num_channels + 1),
                                   num_blocks, max_features)
        cp = self.hourglass.out_features
        self.mask = nn.Conv2d(cp, num_kp + 1, 7, padding=3)
        self.occlusion = nn.Conv2d(cp, 1, 7, padding=3)
        self.scale_factor, self.kp_variance = scale_factor, kp_variance

    def forward(self, source, kp_d, kp_s):
        """source [Bs, C, H, W]; keypoints of batch B, set b of source
        b // (B // Bs) -> deformation [B, h, w, 2], occlusion [B, 1, h, w]."""
        src = ops.blur_downsample(source, self.scale_factor)
        Bs, C, h, w = src.shape
        B, K = kp_d["value"].shape[:2]
        heat = (ops.gaussian_maps(kp_d["value"], h, w, self.kp_variance)
                - ops.gaussian_maps(kp_s["value"], h, w, self.kp_variance))
        heat = torch.cat([heat.new_zeros(B, 1, h, w), heat], 1)
        grids = ops.motion_grids(h, w, kp_d, kp_s)             # [B,K+1,h,w,2]
        deformed = ops.warp(src, grids.reshape(B * (K + 1), h, w, 2))
        x = torch.cat([heat[:, :, None], deformed.view(B, K + 1, C, h, w)], 2)
        pred = self.hourglass(x.reshape(B, (K + 1) * (C + 1), h, w))
        mask = torch.softmax(self.mask(pred), 1)
        deformation = (mask[..., None] * grids).sum(1)
        return deformation, torch.sigmoid(self.occlusion(pred))


class OcclusionAwareGenerator(nn.Module):
    def __init__(self, num_channels, num_kp, block_expansion, max_features,
                 num_down_blocks, num_bottleneck_blocks,
                 estimate_occlusion_map, dense_motion_params):
        super().__init__()
        assert estimate_occlusion_map
        self.dense_motion_network = DenseMotionNetwork(
            num_kp=num_kp, num_channels=num_channels, **dense_motion_params)
        w = [_width(block_expansion, max_features, i)
             for i in range(num_down_blocks + 1)]
        self.first = SameBlock(num_channels, block_expansion, 7, 3)
        self.down_blocks = nn.ModuleList(
            DownBlock(w[i], w[i + 1]) for i in range(num_down_blocks))
        self.bottleneck = nn.ModuleDict(
            {f"r{i}": ResBlock(w[-1]) for i in range(num_bottleneck_blocks)})
        self.up_blocks = nn.ModuleList(
            UpBlock(w[num_down_blocks - i], w[num_down_blocks - i - 1])
            for i in range(num_down_blocks))
        self.final = nn.Conv2d(block_expansion, num_channels, 7, padding=3)

    def encode_source(self, source):
        out = self.first(source)
        for block in self.down_blocks:
            out = block(out)
        return out

    def decode(self, source, feats, kp_d, kp_s):
        """Frames [B, C, H, W] in [0, 1]; frame b warps source
        b // (B // Bs) and its features."""
        deformation, occlusion = self.dense_motion_network(source, kp_d,
                                                           kp_s)
        h, w = feats.shape[2:]
        if deformation.shape[1:3] != (h, w):
            deformation = F.interpolate(
                deformation.permute(0, 3, 1, 2), size=(h, w),
                mode="bilinear", align_corners=False).permute(0, 2, 3, 1)
        if occlusion.shape[2:] != (h, w):
            occlusion = F.interpolate(occlusion, size=(h, w),
                                      mode="bilinear", align_corners=False)
        out = ops.warp(feats, deformation) * occlusion
        for block in self.bottleneck.values():
            out = block(out)
        for block in self.up_blocks:
            out = block(out)
        return torch.sigmoid(self.final(out))


# ----------------------------------------------------------------- ATNet

class PixelNorm(nn.Module):
    def forward(self, x):
        return x * torch.rsqrt((x * x).mean(1, keepdim=True) + 1e-8)


class EqualLinear(nn.Module):
    """StyleGAN2's equalized dense layer: weight / lr_mul drawn N(0, 1),
    used as weight * lr_mul / sqrt(in); bias * lr_mul; with
    ``activation`` a leaky ReLU (0.2) times sqrt(2)."""

    def __init__(self, cin, cout, lr_mul=1.0, bias_init=0.0,
                 activation=False):
        super().__init__()
        self.weight = nn.Parameter(torch.randn(cout, cin) / lr_mul)
        self.bias = nn.Parameter(torch.full((cout,), float(bias_init)))
        self.lr_mul, self.activation = lr_mul, activation
        self.bias_init = bias_init

    def forward(self, x):
        out = x @ (self.weight * (self.lr_mul / math.sqrt(x.shape[1]))).t() \
            + self.bias * self.lr_mul
        if self.activation:
            out = F.leaky_relu(out, 0.2) * math.sqrt(2)
        return out


def fir_blur(x: torch.Tensor, pad: tuple, up: int = 1) -> torch.Tensor:
    """StyleGAN2's upfirdn2d with the [1, 3, 3, 1] filter: ``up - 1``
    zeros after each sample, ``pad`` zeros before and after, a depthwise
    convolution with the normalized filter times 4 (both blurs here follow
    a 2x upsampling: ``up`` 2 in ToRGB's skip, the transposed convolution's
    stride in the modulated one)."""
    B, C, H, W = x.shape
    if up > 1:
        z = x.new_zeros(B, C, H * up, W * up)
        z[:, :, ::up, ::up] = x
        x = z
    x = F.pad(x, (pad[0], pad[1], pad[0], pad[1]))
    k = np.outer([1, 3, 3, 1], [1, 3, 3, 1]).astype(np.float64)
    k = torch.as_tensor(k / k.sum() * 4,
                        dtype=x.dtype, device=x.device)
    return F.conv2d(x, k.expand(C, 1, 4, 4), groups=C)


class ModulatedConv(nn.Module):
    """StyleGAN2's modulated convolution in its non-fused form: the input
    scaled by the style, one convolution with the shared weight, the output
    scaled by the demodulation coefficients rsqrt(sum (w * style)^2 +
    1e-8) (unless told not to); ``upsample`` a stride-2 transposed
    convolution and the blur."""

    def __init__(self, cin, cout, kernel, style_dim=256, demodulate=True,
                 upsample=False):
        super().__init__()
        self.weight = nn.Parameter(torch.randn(1, cout, cin, kernel, kernel))
        self.modulation = EqualLinear(style_dim, cin, bias_init=1.0)
        self.kernel, self.demodulate, self.upsample = kernel, demodulate, \
            upsample

    def forward(self, x, style):
        cin, k = x.shape[1], self.kernel
        w = self.weight[0] / math.sqrt(cin * k * k)             # [O, I, k, k]
        s = self.modulation(style)                              # [B, I]
        x = x * s[:, :, None, None]
        if self.upsample:
            out = F.conv_transpose2d(x, w.transpose(0, 1), stride=2)
        else:
            out = F.conv2d(x, w, padding=k // 2)
        if self.demodulate:
            d = (w[None] * s[:, None, :, None, None]).square().sum((2, 3, 4))
            out = out * torch.rsqrt(d + 1e-8)[:, :, None, None]
        if self.upsample:
            out = fir_blur(out, (1, 1))
        return out


class FusedLeakyReLU(nn.Module):
    def __init__(self, c):
        super().__init__()
        self.bias = nn.Parameter(torch.zeros(c))

    def forward(self, x):
        return F.leaky_relu(x + self.bias[:, None, None], 0.2) * math.sqrt(2)


class StyledConv(nn.Module):
    def __init__(self, cin, cout, style_dim, upsample=False):
        super().__init__()
        self.conv = ModulatedConv(cin, cout, 3, style_dim, upsample=upsample)
        self.activate = FusedLeakyReLU(cout)

    def forward(self, x, style):
        return self.activate(self.conv(x, style))


class ToRGB(nn.Module):
    def __init__(self, cin, cout, style_dim):
        super().__init__()
        self.conv = ModulatedConv(cin, cout, 1, style_dim, demodulate=False)
        self.bias = nn.Parameter(torch.zeros(1, cout, 1, 1))

    def forward(self, x, style, skip=None):
        out = self.conv(x, style) + self.bias
        if skip is not None:
            out = out + fir_blur(skip, (2, 1), up=2)
        return out


class SynthesisGenerator(nn.Module):
    """EAMM's StyleGAN2 synthesis: the style MLP, the broadcast latent
    as the 4x4 input, no noise, 35 output channels at 64 x 64."""

    def __init__(self, size=64, style_dim=256, n_mlp=8, out_channels=35):
        super().__init__()
        ch = {4: 256, 8: 256, 16: 128, 32: 64, 64: 32}
        self.style = nn.Sequential(PixelNorm(), *(
            EqualLinear(style_dim, style_dim, lr_mul=0.01, activation=True)
            for _ in range(n_mlp)))
        self.conv1 = StyledConv(style_dim, ch[4], style_dim)
        self.to_rgb1 = ToRGB(ch[4], out_channels, style_dim)
        self.convs, self.to_rgbs = nn.ModuleList(), nn.ModuleList()
        cin = ch[4]
        for res in range(3, int(math.log2(size)) + 1):
            c = ch[2 ** res]
            self.convs.append(StyledConv(cin, c, style_dim, upsample=True))
            self.convs.append(StyledConv(c, c, style_dim))
            self.to_rgbs.append(ToRGB(c, out_channels, style_dim))
            cin = c

    def forward(self, latent):
        s = self.style(latent)
        out = self.conv1(s[:, :, None, None].expand(-1, -1, 4, 4), s)
        skip = self.to_rgb1(out, s)
        for i, to_rgb in enumerate(self.to_rgbs):
            out = self.convs[2 * i + 1](self.convs[2 * i](out, s), s)
            skip = to_rgb(out, s, skip)
        return skip


def deconv_decoder():
    layers = []
    specs = [(256, 256, 6), (256, 128, 4), (128, 128, 4), (128, 128, 4),
             (128, 35, 4)]
    for i, (cin, cout, k) in enumerate(specs):
        layers.append(nn.ConvTranspose2d(cin, cout, k, 2, 1))
        if i < len(specs) - 1:
            layers += [nn.BatchNorm2d(cout), nn.ReLU()]
    return nn.Sequential(*layers)


class ATNet(nn.Module):
    """Identity image, MFCC windows and head pose -> one 35-channel 64 x 64
    map a frame, through a 3-layer LSTM and the ``jaco_net`` decoder."""

    def __init__(self, jaco_net="cnn"):
        super().__init__()
        self.down_blocks = nn.ModuleList(
            DownBlock(3 if i == 0 else 2 ** (i + 1), 2 ** (i + 2))
            for i in range(8))
        self.pose_encoder = nn.Sequential(
            nn.Linear(6, 128), nn.ReLU(), nn.Linear(128, 256), nn.ReLU())
        self.audio_eocder = nn.Sequential(
            conv_block(1, 64), conv_block(64, 128),
            nn.MaxPool2d(3, stride=(1, 2)),
            conv_block(128, 256), conv_block(256, 256), conv_block(256, 512),
            nn.MaxPool2d(3, stride=(2, 2)))
        self.audio_eocder_fc = nn.Sequential(
            nn.Linear(512 * 12 * 2, 2048), nn.ReLU(),
            nn.Linear(2048, 256), nn.ReLU())
        self.lstm = nn.LSTM(1024, 256, 3, batch_first=True)
        self.jaco_net = jaco_net
        if jaco_net == "cnn":
            self.decon = deconv_decoder()
        else:
            self.generator = SynthesisGenerator()

    def forward(self, image, audio, pose, audio_weight=1.0):
        """image [B, 3, 256, 256], audio [B, T, 28, 12], pose [B, T, 6]
        -> [B, T, 35, 64, 64]."""
        B, T = audio.shape[:2]
        ident = image
        for block in self.down_blocks:
            ident = block(ident)
        a = self.audio_eocder(audio.reshape(B * T, 1, 28, 12))
        a = self.audio_eocder_fc(a.reshape(B * T, -1)) * audio_weight
        p = self.pose_encoder(pose.reshape(B * T, 6))
        x = torch.cat([ident.reshape(B, 1, -1).expand(B, T, -1),
                       a.reshape(B, T, -1), p.reshape(B, T, -1)], -1)
        h, _ = self.lstm(x)
        h = h.reshape(B * T, 256)
        maps = (self.decon(h[:, :, None, None]) if self.jaco_net == "cnn"
                else self.generator(h))
        return maps.reshape(B, T, 35, 64, 64)


# ------------------------------------------------------------------- VGG

class Vgg19(nn.Module):
    """VGG19's features to index 29, ImageNet-normalized input, the five
    after-ReLU maps at indices 1, 6, 11, 20 and 29."""

    LAYERS = (64, 64, "M", 128, 128, "M", 256, 256, 256, 256, "M",
              512, 512, 512, 512, "M", 512)
    OUTPUTS = (1, 6, 11, 20, 29)

    def __init__(self):
        super().__init__()
        layers, cin = [], 3
        for item in self.LAYERS:
            if item == "M":
                layers.append(nn.MaxPool2d(2, 2))
            else:
                layers += [nn.Conv2d(cin, item, 3, padding=1), nn.ReLU()]
                cin = item
        self.features = nn.Sequential(*layers)

    def forward(self, x):
        mean = x.new_tensor([0.485, 0.456, 0.406])[None, :, None, None]
        std = x.new_tensor([0.229, 0.224, 0.225])[None, :, None, None]
        h, outs = (x - mean) / std, []
        for i, layer in enumerate(self.features):
            h = layer(h)
            if i in self.OUTPUTS:
                outs.append(h)
        return outs


# ------------------------------------------------------------- factories

def build(config: dict, names=None) -> dict:
    """The reference networks of ``config`` (the reference YAML's
    ``model_params`` and ``train_params.jaco_net``), by their checkpoint
    names; with ``names``, only those."""
    mp = config["model_params"]
    common, kp = mp["common_params"], mp["kp_detector_params"]
    g = mp["generator_params"]
    make = {
        "generator": lambda: OcclusionAwareGenerator(
            common["num_channels"], common["num_kp"], g["block_expansion"],
            g["max_features"], g["num_down_blocks"],
            g["num_bottleneck_blocks"], g["estimate_occlusion_map"],
            g["dense_motion_params"]),
        "kp_detector": lambda: KPDetector(
            common["num_kp"], kp["block_expansion"], kp["max_features"],
            kp["num_blocks"], kp["temperature"], kp["scale_factor"],
            common["num_channels"]),
        "kp_detector_a": lambda: KPDetectorA(mp["audio_params"]["num_kp"],
                                             kp["temperature"]),
        "audio_feature": lambda: ATNet(config["train_params"]["jaco_net"]),
        "vgg": Vgg19,
    }
    names = [n for n in make if n != "vgg"] if names is None else names
    return {name: make[name]() for name in names}


def loaded(config: dict, sds: dict, names=None) -> dict:
    """The networks ``names`` (default: every one in ``sds``) holding
    copies of their state dicts in ``sds``, on the state dicts' device:
    built on the meta device and given the tensors, so that no default
    initialization runs."""
    names = list(sds) if names is None else list(names)
    with torch.device("meta"):
        nets = build(config, names)
    for name, net in nets.items():
        net.load_state_dict({k: v.clone() for k, v in sds[name].items()},
                            assign=True)
    return nets
