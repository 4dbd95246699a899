"""Implicit emotion displacement learners (NCHW, eval semantics).

Counterpart of ``eamm_tpu/models/emotion.py``.  A mouth-masked emotion
frame goes through antialias x0.25 -> Hourglass -> a ResNet-18 trunk ->
global mean (a 512-d feature); the ten neutral keypoints (value and
Jacobian, 6 numbers each) go through a positional embedding and an MLP;
heads turn both into additive displacements for a subset of keypoints.

``EmotionK`` (linear heads: ``linear`` (the demo's ``linear_3``),
``linear_10``, ``linear_4``, ``linear_np_4``, ``linear_np_10``) ends in
small Conv1d stacks; ``EmotionMap`` (``map`` / ``map_10``, ``map_4``)
decodes a 35-channel 64x64 map and reads keypoints from it with 7x7 conv
heads and the keypoint-expectation kernel.  Both return
``({'value': [B, n, 2], 'jacobian': [B, n, 2, 2]}, logits [B, 8])``.

Names are the reference checkpoints' (``predictor``, ``conv1``/``bn1``,
``layer{1..4}.{0,1}``, ``fc_p``, ``fc_n``, ``fc_all``, ``fc_single``,
``classify.last_fc``, ``final``, ``final_10``; EmotionMap ``final`` (the
transposed-conv decoder), ``kp``, ``jacobian``, ``kp_4``, ``jacobian_4``).
``final_4`` is built by no head, and the JAX package creates no parameters
for it, so the port has none.  The JAX ``Conv1dBlock`` runs NLC behind
``swapaxes``; a torch ``Conv1d`` on [B, C, L] is that layout already.
"""
from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from eamm_tpu_torch.models.blocks import Hourglass
from eamm_tpu_torch.models.kp_detector import keypoint_heads, reset_jacobian
from eamm_tpu_torch.ops.antialias import antialias_downsample

NUM_KP = 10


def positional_embed(x: torch.Tensor, num_freqs: int = 10) -> torch.Tensor:
    """[x, sin(2^i x), cos(2^i x) for i < num_freqs] on the last axis (6
    inputs per keypoint -> 126)."""
    outs = [x]
    for i in range(num_freqs):
        freq = 2.0 ** i
        outs += [torch.sin(x * freq), torch.cos(x * freq)]
    return torch.cat(outs, dim=-1)


class BasicBlock(nn.Module):
    """ResNet-18 basic block, post-activation; ``downsample`` is a 1x1
    strided conv and BN on the residual."""

    def __init__(self, in_features: int, features: int, stride: int = 1,
                 downsample: bool = False):
        super().__init__()
        self.conv1 = nn.Conv2d(in_features, features, 3, stride, 1, bias=False)
        self.bn1 = nn.BatchNorm2d(features)
        self.conv2 = nn.Conv2d(features, features, 3, 1, 1, bias=False)
        self.bn2 = nn.BatchNorm2d(features)
        self.downsample = nn.Sequential(
            nn.Conv2d(in_features, features, 1, stride, bias=False),
            nn.BatchNorm2d(features)) if downsample else None

    def forward(self, x):
        residual = x if self.downsample is None else self.downsample(x)
        out = F.relu(self.bn1(self.conv1(x)))
        return F.relu(self.bn2(self.conv2(out)) + residual)


def _mlp(*sizes: int) -> nn.Sequential:
    """Linear -> ReLU for each consecutive pair of ``sizes``."""
    layers = []
    for fan_in, fan_out in zip(sizes[:-1], sizes[1:]):
        layers += [nn.Linear(fan_in, fan_out), nn.ReLU()]
    return nn.Sequential(*layers)


class _Classify(nn.Module):
    """The 8-way emotion classifier (reference name ``classify.last_fc``)."""

    def __init__(self, num_classes: int):
        super().__init__()
        self.last_fc = nn.Linear(512, num_classes)

    def forward(self, x):
        return self.last_fc(x)


def _neutral(value: torch.Tensor, jacobian: torch.Tensor) -> torch.Tensor:
    """[B, K, 2] and [B, K, 2, 2] -> [B, K, 6]."""
    B, K = value.shape[:2]
    return torch.cat([value, jacobian.reshape(B, K, 4)], dim=2)


def _split(result: torch.Tensor) -> dict:
    """[B, n, 6] -> {'value': [B, n, 2], 'jacobian': [B, n, 2, 2]}."""
    B, n = result.shape[:2]
    return {"value": result[:, :, :2],
            "jacobian": result[:, :, 2:].reshape(B, n, 2, 2)}


class _EmotionBase(nn.Module):
    """What EmotionK and EmotionMap share: the image feature and the
    positional-embedding MLP of the neutral keypoints."""

    def __init__(self, block_expansion: int, num_channels: int,
                 max_features: int, num_blocks: int, scale_factor: float,
                 num_classes: int, neutral_mlp: bool = True):
        super().__init__()
        self.predictor = Hourglass(block_expansion, num_channels, num_blocks,
                                   max_features)
        # the JAX ResNetTrunk, its parts at the top level as the reference
        # names them
        self.conv1 = nn.Conv2d(self.predictor.out_features, 64, 3, 1, 1,
                               bias=False)
        self.bn1 = nn.BatchNorm2d(64)
        inplanes = 64
        for li, (planes, stride) in enumerate(
                [(64, 1), (128, 2), (256, 2), (512, 2)]):
            setattr(self, f"layer{li + 1}", nn.Sequential(
                BasicBlock(inplanes, planes, stride, stride != 1),
                BasicBlock(planes, planes)))
            inplanes = planes
        if neutral_mlp:            # EmDetector (models/aux.py) has none
            self.fc_p = _mlp(NUM_KP * 126, 1024, 512)
        self.classify = _Classify(num_classes)
        self.scale_factor = scale_factor

    def feature(self, x: torch.Tensor) -> torch.Tensor:
        """Image [B, 3, H, W] -> 512-d trunk feature [B, 512]."""
        xs = antialias_downsample(x.permute(0, 2, 3, 1), self.scale_factor)
        fm = self.predictor(xs.permute(0, 3, 1, 2))
        return self.trunk(fm)

    def trunk(self, feature_map: torch.Tensor) -> torch.Tensor:
        """ResNetTrunk: conv1 3x3 -> BN -> ReLU -> max-pool 3/2/1 -> layers
        of [2, 2, 2, 2] basic blocks (64, 128, 256, 512) -> global mean ->
        [B, 512]."""
        f = F.max_pool2d(F.relu(self.bn1(self.conv1(feature_map))), 3, 2, 1)
        f = self.layer4(self.layer3(self.layer2(self.layer1(f))))
        return f.mean(dim=(2, 3))

    def _embedded(self, value, jacobian):
        neu = _neutral(value, jacobian)
        return self.fc_p(positional_embed(neu).reshape(neu.shape[0], -1))


class EmotionK(_EmotionBase):
    """Linear-head emotion displacement learner."""

    def __init__(self, block_expansion: int = 32, num_channels: int = 3,
                 max_features: int = 1024, num_blocks: int = 5,
                 scale_factor: float = 0.25, num_classes: int = 8):
        super().__init__(block_expansion, num_channels, max_features,
                         num_blocks, scale_factor, num_classes)
        self.fc_n = _mlp(NUM_KP * 6, 128, 512)
        self.fc_all = _mlp(1024, 512, 256, 64)
        self.fc_single = _mlp(512, 256, 64)
        # final: Conv1d(1,2,4,2,1) -> MaxPool1d(2) -> ReLU -> Conv1d(2,4,4,2,1)
        # -> ReLU -> Conv1d(4,4,3); [B, 1, 64] -> [B, 4, 6]
        self.final = nn.Sequential(
            nn.Conv1d(1, 2, 4, 2, 1), nn.MaxPool1d(2, 2), nn.ReLU(),
            nn.Conv1d(2, 4, 4, 2, 1), nn.ReLU(), nn.Conv1d(4, 4, 3))
        # final_10: [B, 4, 16] -> [B, 10, 6]
        self.final_10 = nn.Sequential(
            nn.Conv1d(4, 8, 3, 1, 1), nn.MaxPool1d(2, 2), nn.ReLU(),
            nn.Conv1d(8, 10, 3))

    def _neutral_feature(self, value, jacobian, use_embedding: bool):
        if use_embedding:
            return self._embedded(value, jacobian)
        neu = _neutral(value, jacobian)
        return self.fc_n(neu.reshape(neu.shape[0], -1))

    def _head(self, head: str, out, value, jacobian) -> dict:
        if head == "linear_4":
            return _split(self.final(self.fc_single(out)[:, None]))
        if head not in ("linear", "linear_10", "linear_np_4", "linear_np_10"):
            raise ValueError(f"unknown EmotionK head {head!r}")
        ner = self._neutral_feature(value, jacobian, "_np_" not in head)
        all_fc = self.fc_all(torch.cat([out, ner], dim=1))
        if head.endswith("_10"):
            return _split(self.final_10(all_fc.reshape(-1, 4, 16)))
        return _split(self.final(all_fc[:, None]))

    def forward(self, x, value, jacobian, head: str = "linear"):
        """Emotion frames [B, 3, H, W] and neutral keypoints -> (displacement
        kp, emotion logits)."""
        out = self.feature(x)
        return self._head(head, out, value, jacobian), self.classify(out)

    def emotion_feature(self, feature, value, jacobian):
        """The ``linear`` head from a precomputed [B, 512] trunk feature."""
        return (self._head("linear", feature, value, jacobian),
                self.classify(feature))


class EmotionMap(_EmotionBase):
    """Map-head emotion displacement learner: decode a 35-channel 64x64 map
    and read 10 (``map``) or 4 (``map_4``) keypoints from it."""

    def __init__(self, block_expansion: int = 32, num_channels: int = 3,
                 max_features: int = 1024, num_blocks: int = 5,
                 scale_factor: float = 0.25, num_classes: int = 8,
                 temperature: float = 0.1):
        super().__init__(block_expansion, num_channels, max_features,
                         num_blocks, scale_factor, num_classes)
        self.fc_all = _mlp(1024, 2048)
        layers = []
        for i, (cin, cout) in enumerate([(128, 128), (128, 64), (64, 64),
                                         (64, 35)]):
            layers.append(nn.ConvTranspose2d(cin, cout, 4, 2, 1))
            if i < 3:
                layers += [nn.BatchNorm2d(cout), nn.ReLU()]
        self.final = nn.Sequential(*layers)
        self.kp = nn.Conv2d(35, NUM_KP, 7)
        self.jacobian = nn.Conv2d(35, 4 * NUM_KP, 7)
        self.kp_4 = nn.Conv2d(35, 4, 7)
        self.jacobian_4 = nn.Conv2d(35, 16, 7)
        self.temperature = temperature

    def reset_jacobian(self) -> None:
        """The reference initialization of both Jacobian heads."""
        reset_jacobian(self.jacobian, NUM_KP)
        reset_jacobian(self.jacobian_4, 4)

    def forward(self, x, value, jacobian, head: str = "map"):
        if head in ("map", "map_10"):
            convs = (self.kp, self.jacobian)
        elif head == "map_4":
            convs = (self.kp_4, self.jacobian_4)
        else:
            raise ValueError(f"unknown EmotionMap head {head!r}")
        out = self.feature(x)
        all_fc = self.fc_all(torch.cat([out, self._embedded(value, jacobian)],
                                       dim=1))
        fmap = self.final(all_fc.reshape(-1, 128, 4, 4))      # [B, 35, 64, 64]
        return keypoint_heads(fmap, *convs, self.temperature), \
            self.classify(out)
