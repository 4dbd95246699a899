"""Keypoint detectors: K keypoints and 2x2 local Jacobians (NCHW).

Counterpart of ``eamm_tpu/models/kp_detector.py``.  ``KPDetector`` reads an
RGB image (blurred and downsampled x0.25 first); ``KPDetectorA`` reads the
35-channel 64x64 map of the audio decoder.  Both end in two unpadded 7x7
convs (``kp``: K logit maps, ``jacobian``: 4K maps), run here as one conv
whose output holds [K logit maps | 4K Jacobian maps], and the keypoint
expectation kernel reads both slices of it in place.

Returns {'value': [B, K, 2], 'jacobian': [B, K, 2, 2]}.
"""
from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from eamm_tpu_torch.models.blocks import Hourglass
from eamm_tpu_torch.ops.antialias import antialias_downsample
from eamm_tpu_torch.ops.kp_expectation import kp_expectation


def keypoint_heads(feature_map: torch.Tensor, kp: nn.Conv2d,
                   jacobian: nn.Conv2d, temperature: float) -> dict:
    """The two 7x7 VALID heads run as one conv whose output holds [K logit
    maps | 4K Jacobian maps], then the expectation kernel reads both slices
    in place."""
    K = kp.out_channels
    weight = torch.cat([kp.weight, jacobian.weight])
    bias = torch.cat([kp.bias, jacobian.bias])
    # a channels_last feature map (N sources of a batched render) gives a
    # channels_last output, whose h*w rows the kernel cannot read in place
    y = F.conv2d(feature_map, weight, bias).contiguous()        # [B, 5K, h, w]
    B, _, h, w = y.shape
    value, jac = kp_expectation(y[:, :K], y[:, K:].view(B, K, 4, h, w),
                                temperature)
    return {"value": value, "jacobian": jac}


def reset_jacobian(jacobian: nn.Conv2d, num_kp: int) -> None:
    """The reference initialization of a Jacobian head: zero weights,
    identity bias."""
    nn.init.zeros_(jacobian.weight)
    with torch.no_grad():
        jacobian.bias.copy_(torch.tensor([1.0, 0.0, 0.0, 1.0]).repeat(num_kp))


class KPHead(nn.Module):
    """The two heads and the expectation (names ``kp`` and ``jacobian``
    are the reference's, set on the owning detector)."""

    def __init__(self, in_features: int, num_kp: int, temperature: float):
        super().__init__()
        self.kp = nn.Conv2d(in_features, num_kp, 7)
        self.jacobian = nn.Conv2d(in_features, 4 * num_kp, 7)
        self.num_kp = num_kp
        self.temperature = temperature

    def reset_jacobian(self) -> None:
        reset_jacobian(self.jacobian, self.num_kp)

    def forward(self, feature_map: torch.Tensor) -> dict:
        return keypoint_heads(feature_map, self.kp, self.jacobian,
                              self.temperature)


class KPDetector(KPHead):
    """Image keypoint detector: antialias x scale_factor -> hourglass ->
    heads."""

    def __init__(self, num_kp: int = 10, block_expansion: int = 32,
                 max_features: int = 1024, num_blocks: int = 5,
                 temperature: float = 0.1, scale_factor: float = 0.25,
                 num_channels: int = 3):
        predictor = Hourglass(block_expansion, num_channels, num_blocks,
                              max_features)
        super().__init__(predictor.out_features, num_kp, temperature)
        self.predictor = predictor
        self.scale_factor = scale_factor

    def forward(self, image: torch.Tensor) -> dict:
        x = antialias_downsample(image.permute(0, 2, 3, 1), self.scale_factor)
        return super().forward(self.predictor(x.permute(0, 3, 1, 2)))


class KPDetectorA(KPHead):
    """Audio keypoint detector: the heads alone over the 35-channel map."""

    def __init__(self, num_kp: int = 10, temperature: float = 0.1,
                 in_features: int = 35):
        super().__init__(in_features, num_kp, temperature)
