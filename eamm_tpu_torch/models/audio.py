"""Audio-to-facial-dynamics network (ATNet), NCHW.

Counterpart of ``eamm_tpu/models/audio.py``: identity image, MFCC windows
and head pose -> one 35-channel 64x64 map per video frame, which the audio
keypoint detector reads.  The per-window encoders and the decoder fold the
time axis into the batch; the recurrent part is a 3-layer ``nn.LSTM``
(torch gate order i, f, g, o; zero initial state).  The decoder is the
``jaco_net`` one: ``'cnn'`` five transposed convolutions (``decon``),
``'gan'`` the StyleGAN2 synthesis network (``generator``,
``models/stylegan2.py``: size 64, style 256, 8 MLP layers, 35 channels)
reading each LSTM output as its latent.  Submodule names are the
reference checkpoint's (``down_blocks``, ``audio_eocder``,
``audio_eocder_fc``, ``pose_encoder``, ``lstm``, ``decon``,
``generator``).  The reference builds the deconv decoder in either mode,
so its gan files hold ``decon.*`` too; the gan ATNet does not run it and
has none (``compat.ATNET_UNUSED``).
"""
from __future__ import annotations

import torch
import torch.nn as nn

from eamm_tpu_torch.models.blocks import ConvBlock, DownBlock
from eamm_tpu_torch.models.stylegan2 import SynthesisGenerator

JACO_NETS = ("cnn", "gan")


def deconv_decoder() -> nn.Sequential:
    """[N, 256, 1, 1] -> [N, 35, 64, 64] by five transposed convs, each but
    the last followed by BN and ReLU (sizes 4, 8, 16, 32, 64)."""
    layers = []
    specs = [(256, 256, 6), (256, 128, 4), (128, 128, 4), (128, 128, 4),
             (128, 35, 4)]
    for i, (cin, cout, k) in enumerate(specs):
        layers.append(nn.ConvTranspose2d(cin, cout, k, 2, 1))
        if i < len(specs) - 1:
            layers += [nn.BatchNorm2d(cout), nn.ReLU()]
    return nn.Sequential(*layers)


def audio_encoder() -> tuple[nn.Sequential, nn.Sequential]:
    """(``audio_eocder``, ``audio_eocder_fc``): an MFCC window
    [N, 1, 28, 12] -> [N, 512, 12, 2] -> flattened (c, h, w) -> [N, 256]."""
    conv = nn.Sequential(
        ConvBlock(1, 64), ConvBlock(64, 128),
        nn.MaxPool2d(3, stride=(1, 2)),
        ConvBlock(128, 256), ConvBlock(256, 256), ConvBlock(256, 512),
        nn.MaxPool2d(3, stride=(2, 2)))                   # 28x12 -> 512x12x2
    fc = nn.Sequential(
        nn.Linear(512 * 12 * 2, 2048), nn.ReLU(),
        nn.Linear(2048, 256), nn.ReLU())
    return conv, fc


class ATNetTrunk(nn.Module):
    """The per-window encoders ATNet and TFNet share: identity image
    (``down_blocks``), MFCC window (``audio_eocder``, ``audio_eocder_fc``)
    and pose (``pose_encoder``)."""

    def __init__(self):
        super().__init__()
        self.down_blocks = nn.ModuleList(
            DownBlock(3 if i == 0 else 2 ** (i + 1), 2 ** (i + 2))
            for i in range(8))                            # 256^2 -> 512 x 1^2
        self.pose_encoder = nn.Sequential(
            nn.Linear(6, 128), nn.ReLU(), nn.Linear(128, 256), nn.ReLU())
        self.audio_eocder, self.audio_eocder_fc = audio_encoder()

    def encode_image(self, example_image: torch.Tensor) -> torch.Tensor:
        """[B, 3, 256, 256] -> identity feature [B, 512]."""
        out = example_image
        for block in self.down_blocks:
            out = block(out)
        return out.flatten(1)

    def window_inputs(self, image_feature: torch.Tensor, audio: torch.Tensor,
                      pose: torch.Tensor, audio_weight: float = 1.0
                      ) -> torch.Tensor:
        """Identity feature [B, 512], audio [B, T, 28, 12], pose [B, T, 6]
        -> the LSTM's input [B, T, 1024] (identity, audio, pose)."""
        B, T = audio.shape[:2]
        audio_feature = self.audio_eocder_fc(
            self.audio_eocder(audio.reshape(B * T, 1, *audio.shape[2:]))
            .flatten(1)).view(B, T, -1) * audio_weight
        pose_feature = self.pose_encoder(pose.reshape(B * T, -1)).view(B, T, -1)
        return torch.cat([image_feature[:, None].expand(B, T, -1),
                          audio_feature, pose_feature], dim=-1)


class ATNet(ATNetTrunk):
    def __init__(self, jaco_net: str = "cnn"):
        super().__init__()
        if jaco_net not in JACO_NETS:
            raise ValueError(f"jaco_net must be 'cnn' or 'gan', got "
                             f"{jaco_net!r}")
        self.jaco_net = jaco_net
        self.lstm = nn.LSTM(1024, 256, 3, batch_first=True)
        if jaco_net == "cnn":
            self.decon = deconv_decoder()
        else:
            self.generator = SynthesisGenerator(size=64, style_dim=256,
                                                n_mlp=8, out_channels=35)

    def decode(self, lstm_out: torch.Tensor) -> torch.Tensor:
        """The decoder on [N, 256] LSTM outputs -> [N, 35, 64, 64]."""
        if self.jaco_net == "cnn":
            return self.decon(lstm_out[:, :, None, None])
        return self.generator(lstm_out)

    def window_features(self, image_feature: torch.Tensor,
                        audio: torch.Tensor, pose: torch.Tensor,
                        audio_weight: float = 1.0, carry=None,
                        return_carry: bool = False):
        """Identity feature [B, 512], audio [B,T,28,12], pose [B,T,6] ->
        [B, T, 35, 64, 64].  ``carry`` is the LSTM's (h, c), each
        [3, B, 256] (None: zeros); with ``return_carry`` the final (h, c)
        comes back too, so chunks of windows threaded through it give the
        maps of the whole sequence."""
        B, T = audio.shape[:2]
        lstm_in = self.window_inputs(image_feature, audio, pose, audio_weight)
        lstm_out, carry = self.lstm(lstm_in, carry)       # [B, T, 256]
        deco = self.decode(lstm_out.reshape(B * T, -1))
        deco = deco.view(B, T, *deco.shape[1:])
        return (deco, carry) if return_carry else deco

    def zero_carry(self, batch: int, dtype: torch.dtype = torch.float32,
                   device=None) -> tuple:
        """The LSTM's zero (h, c) for ``batch`` sequences."""
        shape = (self.lstm.num_layers, batch, self.lstm.hidden_size)
        return (torch.zeros(shape, dtype=dtype, device=device),
                torch.zeros(shape, dtype=dtype, device=device))

    def forward(self, example_image: torch.Tensor, audio: torch.Tensor,
                pose: torch.Tensor, audio_weight: float = 1.0
                ) -> torch.Tensor:
        """example_image [B,3,256,256], audio [B,T,28,12], pose [B,T,6] ->
        [B, T, 35, 64, 64]."""
        return self.window_features(self.encode_image(example_image), audio,
                                    pose, audio_weight)
