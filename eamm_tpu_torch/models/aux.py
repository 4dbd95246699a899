"""The reference's auxiliary networks, NCHW; no entry point builds them.

Counterpart of ``eamm_tpu/models/aux.py``:

- ``CtEncoder``: audio content encoder, an MFCC window -> 256-d;
- ``EmotionNet``: audio emotion encoder over the transposed window ->
  128-d;
- ``AF2F`` / ``AF2FS``: [content | emotion] or content -> a 35-channel
  64x64 map (``AF2FS`` ends in a ReLU);
- ``A2I``: an MFCC window -> a 2-channel 64x64 map;
- ``NANet``: a one-channel neutral map -> 35 channels by 3 transposed
  convolutions;
- ``EmDetector``: the emotion models' hourglass and ResNet trunk with the
  8-way classifier;
- ``AudioFeature``: ``CtEncoder`` -> ``AF2FS`` (the emotion encoder runs
  and its output is dropped, as in the reference);
- ``TFNet``: ATNet's encoders with the emotion feature joined in:
  ``'concat'`` into the LSTM's input (``lstm_two``, 1536 -> 256),
  ``'adain_input'`` as a scale and bias of the normalized LSTM input,
  ``'adain_output'`` of the normalized decoded map.

Names are the reference checkpoints' where the JAX package converts them
(``audio_eocder``, ``emotion_eocder``, ``decon``, ``con_encoder``,
``emo_encoder``, ``decoder``, the emotion trunk's, ``lstm_two``).  TFNet's
AdaIN modes are the JAX package's redesign (the reference normalizes
1x1 maps, which zeroes them), so their layers have the port's own names,
``input_style`` and ``output_style``, which no reference file holds.
"""
from __future__ import annotations

import torch
import torch.nn as nn

from eamm_tpu_torch.models.audio import (ATNetTrunk, audio_encoder,
                                     deconv_decoder)
from eamm_tpu_torch.models.blocks import ConvBlock
from eamm_tpu_torch.models.emotion import _EmotionBase


def _window(mfcc: torch.Tensor) -> torch.Tensor:
    """An MFCC window [B, 28, 12] or [B, 1, 28, 12] -> [B, 1, 28, 12]."""
    return mfcc if mfcc.dim() == 4 else mfcc[:, None]


def _decon_stack(channels, first_kernel=6, final_relu: bool = False
                 ) -> nn.Sequential:
    """Transposed convolutions (stride 2, padding 1; the first with
    ``first_kernel``, the rest 4) between consecutive ``channels``, BN and
    ReLU after each but the last."""
    layers = []
    n = len(channels) - 1
    for i, (cin, cout) in enumerate(zip(channels[:-1], channels[1:])):
        layers.append(nn.ConvTranspose2d(cin, cout,
                                         first_kernel if i == 0 else 4, 2, 1))
        if i < n - 1:
            layers += [nn.BatchNorm2d(cout), nn.ReLU()]
    if final_relu:
        layers.append(nn.ReLU())
    return nn.Sequential(*layers)


class CtEncoder(nn.Module):
    """MFCC window [B, (1,) 28, 12] -> content feature [B, 256]."""

    def __init__(self):
        super().__init__()
        self.audio_eocder, self.audio_eocder_fc = audio_encoder()

    def forward(self, mfcc):
        return self.audio_eocder_fc(self.audio_eocder(_window(mfcc))
                                    .flatten(1))


class EmotionNet(nn.Module):
    """MFCC window [B, (1,) 28, 12], transposed to 12 x 28 -> emotion
    feature [B, 128]."""

    def __init__(self):
        super().__init__()
        self.emotion_eocder = nn.Sequential(
            ConvBlock(1, 64), nn.MaxPool2d((1, 3), stride=(1, 2)),
            ConvBlock(64, 128), ConvBlock(128, 256),
            nn.MaxPool2d((12, 1), stride=(12, 1)),
            ConvBlock(256, 512), nn.MaxPool2d((1, 2), stride=(1, 2)))
        self.emotion_eocder_fc = nn.Sequential(
            nn.Linear(512 * 6, 2048), nn.ReLU(), nn.Linear(2048, 128),
            nn.ReLU())

    def forward(self, mfcc):
        x = self.emotion_eocder(_window(mfcc).transpose(2, 3))  # [B,512,1,6]
        return self.emotion_eocder_fc(x.flatten(1))


class AF2F(nn.Module):
    """[content 256 | emotion 128] -> [B, 35, 64, 64]."""

    def __init__(self):
        super().__init__()
        self.decon = _decon_stack([384, 256, 128, 64, 64, 35])

    def forward(self, content, emotion):
        return self.decon(torch.cat([content, emotion], dim=1)[:, :, None,
                                                                None])


class AF2FS(nn.Module):
    """Content [B, 256] -> [B, 35, 64, 64], ending in a ReLU."""

    def __init__(self):
        super().__init__()
        self.decon = _decon_stack([256, 256, 128, 64, 64, 35],
                                  final_relu=True)

    def forward(self, content):
        return self.decon(content[:, :, None, None])


class A2I(nn.Module):
    """MFCC window [B, 28, 12], transposed -> [B, 2, 64, 64]."""

    def __init__(self):
        super().__init__()
        self.audio_eocder = nn.Sequential(
            ConvBlock(1, 64), ConvBlock(64, 128),
            nn.MaxPool2d((1, 5), stride=(1, 2)),
            ConvBlock(128, 256), ConvBlock(256, 256),
            nn.MaxPool2d((5, 5), stride=(2, 2)))
        self.decon = _decon_stack([256, 128, 64, 32, 2], first_kernel=4,
                                  final_relu=True)

    def forward(self, mfcc):
        return self.decon(self.audio_eocder(mfcc[:, None].transpose(2, 3)))


class NANet(nn.Module):
    """Neutral map [B, H, W] -> [B, 35, 8H - 16, 8W - 4] by transposed
    convolutions (2x3 kernel, padding (2, 1), then two 4x4), BN and ReLU
    between."""

    def __init__(self):
        super().__init__()
        self.decon = nn.Sequential(
            nn.ConvTranspose2d(1, 16, (2, 3), 2, (2, 1)), nn.BatchNorm2d(16),
            nn.ReLU(),
            nn.ConvTranspose2d(16, 32, 4, 2, 1), nn.BatchNorm2d(32),
            nn.ReLU(),
            nn.ConvTranspose2d(32, 35, 4, 2, 1))

    def forward(self, neutral):
        return self.decon(neutral[:, None])


class EmDetector(_EmotionBase):
    """Image [B, 3, H, W] -> (trunk feature [B, 512], logits [B, 8])."""

    def __init__(self, block_expansion: int = 32, num_channels: int = 3,
                 max_features: int = 1024, num_blocks: int = 5,
                 scale_factor: float = 0.25, num_classes: int = 8):
        super().__init__(block_expansion, num_channels, max_features,
                         num_blocks, scale_factor, num_classes,
                         neutral_mlp=False)

    def forward(self, x):
        out = self.feature(x)
        return out, self.classify(out)


class AudioFeature(nn.Module):
    """MFCC window -> content encoder -> ``AF2FS``; the emotion encoder
    runs and its output is unused."""

    def __init__(self):
        super().__init__()
        self.con_encoder = CtEncoder()
        self.emo_encoder = EmotionNet()
        self.decoder = AF2FS()

    def forward(self, mfcc):
        content = self.con_encoder(mfcc)
        self.emo_encoder(mfcc)
        return self.decoder(content)


def instance_norm_1x1(x: torch.Tensor, dim: int = -1,
                      eps: float = 1e-8) -> torch.Tensor:
    """Normalize feature vectors over their channel axis ``dim`` (biased
    variance): the JAX package's reading of the reference's InstanceNorm
    on 1x1 maps."""
    var, mean = torch.var_mean(x, dim=dim, keepdim=True, correction=0)
    return (x - mean) * torch.rsqrt(var + eps)


TFNET_MODES = ("concat", "adain_input", "adain_output")


class TFNet(ATNetTrunk):
    """example_image [B, 3, 256, 256], audio [B, T, 28, 12], pose
    [B, T, 6], emo_features [B, T, emo_dim] -> [B, T, 35, 64, 64]."""

    def __init__(self, mode: str = "concat", emo_dim: int = 512):
        super().__init__()
        if mode not in TFNET_MODES:
            raise ValueError(f"unknown TFNet mode {mode!r}")
        self.mode = mode
        if mode == "concat":
            self.lstm_two = nn.LSTM(1024 + emo_dim, 256, 3, batch_first=True)
        else:
            self.lstm = nn.LSTM(1024, 256, 3, batch_first=True)
        if mode == "adain_input":
            self.input_style = nn.Linear(emo_dim, 2 * 1024)
        self.decon = deconv_decoder()
        if mode == "adain_output":
            self.output_style = nn.Linear(emo_dim, 2 * 35)

    def forward(self, example_image, audio, pose, emo_features):
        B, T = audio.shape[:2]
        feats = self.window_inputs(self.encode_image(example_image), audio,
                                   pose)
        if self.mode == "concat":
            lstm_out, _ = self.lstm_two(torch.cat([feats, emo_features], -1))
        else:
            if self.mode == "adain_input":
                scale, bias = self.input_style(emo_features).chunk(2, dim=-1)
                feats = instance_norm_1x1(feats) * (scale + 1.0) + bias
            lstm_out, _ = self.lstm(feats)
        deco = self.decon(lstm_out.reshape(B * T, -1, 1, 1))
        deco = deco.view(B, T, *deco.shape[1:])
        if self.mode == "adain_output":
            scale, bias = self.output_style(emo_features).chunk(2, dim=-1)
            deco = (instance_norm_1x1(deco, dim=2)
                    * (scale[..., None, None] + 1.0) + bias[..., None, None])
        return deco
