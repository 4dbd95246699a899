"""Keypoint detectors: K keypoints and 2x2 local Jacobians (NCHW).

Counterpart of ``eamm_tpu/models/kp_detector.py``.  ``KPDetector`` reads an
RGB image (blurred and downsampled x0.25 first); ``KPDetectorA`` reads the
35-channel 64x64 map of the audio decoder.  Both end in two unpadded 7x7
convs (``kp``: K logit maps, ``jacobian``: 4K maps), run here as one conv
whose output holds [K logit maps | 4K Jacobian maps], and the keypoint
expectation kernel reads both slices of it.  The JAX module's eval form,
``conv_s2d`` (block 4, no padding) then the VALID slice, is here
(``heads_conv`` with ``fold_heads``) but not taken: on an NVIDIA H100 80GB
HBM3 at 700 W it took 13.55 ms of a neutral 10 s request against the
literal conv's 8.37 ms (``chip_profile.py`` ``conv_forms``, both
detectors' heads; the audio heads read 249 maps of 35 x 64 x 64 in
float32, and the fold multiplies 3.6x the operations).

Returns {'value': [B, K, 2], 'jacobian': [B, K, 2, 2]}; in training also
'heatmap' [B, K, h, w], the softmax of the logits that the part1 mimic
loss reads (``heatmap_softmax``, plain torch, as in JAX).  As in JAX, a
head built with ``estimate_jacobian=False`` has no ``jacobian`` conv and
returns the heatmap's expected position (``gaussian2kp``) and no
Jacobian, and one with ``single_jacobian_map=True`` has one 4-channel
Jacobian map that every keypoint weights by its heatmap; those two forms
are plain PyTorch (the expectation kernel takes one map per keypoint).  The expectation
kernel takes float32: bfloat16 logits and Jacobian maps are cast to
float32 around it (its backward too), as the TPU kernel computes in
float32.
"""
from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from eamm_tpu_torch.models.blocks import Hourglass
from eamm_tpu_torch.ops.antialias import antialias_downsample
from eamm_tpu_torch.ops.grid import gaussian2kp, heatmap_softmax
from eamm_tpu_torch.ops.kp_expectation import kp_expectation
from eamm_tpu_torch.ops.subpixel import conv_s2d_folded, fold_conv_kernel_s2d

HEADS_BLOCK = 4          # of the JAX eval form (module docstring)


def fold_heads(kp: nn.Conv2d, jacobian: nn.Conv2d) -> tuple:
    """Both heads' weights concatenated and folded for ``conv_s2d`` with no
    padding -> (weight, bias repeated per phase, row pads, column pads)."""
    w, pads_r, pads_c = fold_conv_kernel_s2d(
        torch.cat([kp.weight, jacobian.weight]), HEADS_BLOCK, pad=0)
    bias = torch.cat([kp.bias, jacobian.bias])
    return w, bias.repeat_interleave(HEADS_BLOCK ** 2), pads_r, pads_c


def heads_conv(feature_map: torch.Tensor, kp: nn.Conv2d, jacobian: nn.Conv2d,
               folded: tuple | None = None) -> torch.Tensor:
    """[K logit maps | 4K Jacobian maps] of the two 7x7 VALID heads, one
    contiguous [B, 5K, h, w] tensor: by one literal conv, or with
    ``folded`` (``fold_heads``) by ``conv_s2d`` then the VALID slice."""
    if folded is None:
        y = F.conv2d(feature_map, torch.cat([kp.weight, jacobian.weight]),
                     torch.cat([kp.bias, jacobian.bias]))
    else:
        w, b, pads_r, pads_c = folded
        H, W = feature_map.shape[2:]
        k = kp.kernel_size[0]
        y = conv_s2d_folded(feature_map, w, pads_r, pads_c, HEADS_BLOCK,
                            b)[:, :, :H - k + 1, :W - k + 1]
    # the kernel reads rows of h*w in place: a VALID slice, or the
    # channels_last output of a channels_last feature map (N sources of a
    # batched render), is copied once
    return y.contiguous()


def keypoint_heads(feature_map: torch.Tensor, kp: nn.Conv2d,
                   jacobian: nn.Conv2d, temperature: float,
                   with_heatmap: bool = False) -> dict:
    """The two 7x7 VALID heads as one literal conv (``heads_conv``), then
    the expectation kernel reads both slices of their output in place;
    ``with_heatmap`` adds the softmax heatmap of the logits."""
    K = kp.out_channels
    y = heads_conv(feature_map, kp, jacobian)                  # [B, 5K, h, w]
    B, _, h, w = y.shape
    y32 = y.to(torch.promote_types(y.dtype, torch.float32))
    value, jac = kp_expectation(y32[:, :K], y32[:, K:].view(B, K, 4, h, w),
                                temperature)
    out = {"value": value, "jacobian": jac}
    if with_heatmap:
        out["heatmap"] = heatmap_softmax(y[:, :K], temperature)
    return out


def plain_heads(feature_map: torch.Tensor, kp: nn.Conv2d,
                jacobian: nn.Conv2d | None, temperature: float,
                with_heatmap: bool = False) -> dict:
    """The heads without the expectation kernel (JAX's ``_KPHead`` when it
    estimates no Jacobian or one map for all keypoints): value by
    ``gaussian2kp`` of the heatmap; the Jacobian, where ``jacobian`` is
    given, the heatmap-weighted sum of its M = 1 map per keypoint."""
    K = kp.out_channels
    y = (F.conv2d(feature_map, kp.weight, kp.bias) if jacobian is None
         else heads_conv(feature_map, kp, jacobian))
    heatmap = heatmap_softmax(y[:, :K], temperature)
    out = {"value": gaussian2kp(heatmap)}
    if jacobian is not None:
        B, _, h, w = y.shape
        jmap = y[:, K:].reshape(B, -1, 4, h, w)             # [B, M, 4, h, w]
        jac = (heatmap[:, :, None] * jmap).sum(dim=(-2, -1))  # [B, K, 4]
        out["jacobian"] = jac.reshape(B, K, 2, 2)
    if with_heatmap:
        out["heatmap"] = heatmap
    return out


def reset_jacobian(jacobian: nn.Conv2d, num_kp: int) -> None:
    """The reference initialization of a Jacobian head: zero weights,
    identity bias."""
    nn.init.zeros_(jacobian.weight)
    with torch.no_grad():
        jacobian.bias.copy_(torch.tensor([1.0, 0.0, 0.0, 1.0]).repeat(num_kp))


class KPHead(nn.Module):
    """The two heads and the expectation (names ``kp`` and ``jacobian``
    are the reference's, set on the owning detector); no ``jacobian`` conv
    without ``estimate_jacobian``, a 4-channel one with
    ``single_jacobian_map``."""

    def __init__(self, in_features: int, num_kp: int, temperature: float,
                 estimate_jacobian: bool = True,
                 single_jacobian_map: bool = False):
        super().__init__()
        self.kp = nn.Conv2d(in_features, num_kp, 7)
        self.num_maps = 1 if single_jacobian_map else num_kp
        self.jacobian = (nn.Conv2d(in_features, 4 * self.num_maps, 7)
                         if estimate_jacobian else None)
        self.num_kp = num_kp
        self.temperature = temperature

    def reset_jacobian(self) -> None:
        if self.jacobian is not None:
            reset_jacobian(self.jacobian, self.num_maps)

    def forward(self, feature_map: torch.Tensor) -> dict:
        if self.jacobian is None or self.num_maps != self.num_kp:
            return plain_heads(feature_map, self.kp, self.jacobian,
                               self.temperature, with_heatmap=self.training)
        return keypoint_heads(feature_map, self.kp, self.jacobian,
                              self.temperature, with_heatmap=self.training)


class KPDetector(KPHead):
    """Image keypoint detector: antialias x scale_factor -> hourglass ->
    heads."""

    def __init__(self, num_kp: int = 10, block_expansion: int = 32,
                 max_features: int = 1024, num_blocks: int = 5,
                 temperature: float = 0.1, scale_factor: float = 0.25,
                 num_channels: int = 3, estimate_jacobian: bool = True,
                 single_jacobian_map: bool = False):
        predictor = Hourglass(block_expansion, num_channels, num_blocks,
                              max_features)
        super().__init__(predictor.out_features, num_kp, temperature,
                         estimate_jacobian, single_jacobian_map)
        self.predictor = predictor
        self.scale_factor = scale_factor

    def forward(self, image: torch.Tensor) -> dict:
        x = antialias_downsample(image.permute(0, 2, 3, 1), self.scale_factor)
        return super().forward(self.predictor(x.permute(0, 3, 1, 2)))


class KPDetectorA(KPHead):
    """Audio keypoint detector: the heads alone over the 35-channel map."""

    def __init__(self, num_kp: int = 10, temperature: float = 0.1,
                 in_features: int = 35, estimate_jacobian: bool = True,
                 single_jacobian_map: bool = False):
        super().__init__(in_features, num_kp, temperature,
                         estimate_jacobian, single_jacobian_map)
