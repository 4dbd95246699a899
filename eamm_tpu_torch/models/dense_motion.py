"""Sparse keypoint motion -> dense deformation field + occlusion map (NCHW).

Counterpart of ``eamm_tpu/models/dense_motion.py`` on its shared-source
path: the source batch Bs divides the keypoint batch B, keypoint set b
belongs to source b // (B // Bs), and the source is downsampled once per
source rather than once per frame.  The K+1 deformed copies of the
downsampled source are one launch of the narrow warp kernel, which reads
each source in place.

In eval, when the map sides are multiples of 4, the two 7x7 heads
(``mask``, K+1 maps, and ``occlusion``, 1) run as one ``conv_s2d`` (block
4) over their concatenated weights, folded once per load, and the result
is split, as the JAX module does: on an NVIDIA H100 80GB HBM3 at 700 W,
2.05 ms of a neutral 10 s request against the two literal convs' 5.20
(``chip_profile.py`` ``conv_forms``).
"""
from __future__ import annotations

import torch
import torch.nn as nn

from eamm_tpu_torch.models.blocks import FoldedWeights, Hourglass
from eamm_tpu_torch.ops.antialias import antialias_downsample
from eamm_tpu_torch.ops.grid import kp2gaussian
from eamm_tpu_torch.ops.motion import sparse_motions
from eamm_tpu_torch.ops.subpixel import conv_s2d_folded, fold_conv_kernel_s2d
from eamm_tpu_torch.ops.warp_cuda import grid_sample_narrow

HEADS_BLOCK = 4          # of the heads' eval form


class DenseMotionNetwork(FoldedWeights, nn.Module):
    def __init__(self, num_kp: int = 10, num_channels: int = 3,
                 block_expansion: int = 64, max_features: int = 1024,
                 num_blocks: int = 5, scale_factor: float = 0.25,
                 kp_variance: float = 0.01,
                 estimate_occlusion_map: bool = True):
        super().__init__()
        self.hourglass = Hourglass(block_expansion,
                                   (num_kp + 1) * (num_channels + 1),
                                   num_blocks, max_features)
        cp = self.hourglass.out_features
        self.mask = nn.Conv2d(cp, num_kp + 1, 7, padding=3)
        self.occlusion = (nn.Conv2d(cp, 1, 7, padding=3)
                          if estimate_occlusion_map else None)
        self.num_kp = num_kp
        self.scale_factor = scale_factor
        self.kp_variance = kp_variance

    def forward(self, source_image: torch.Tensor, kp_driving: dict,
                kp_source: dict) -> dict:
        """source_image [Bs, C, H, W]; keypoint dicts of batch B.

        Returns 'deformation' [B, h, w, 2], 'occlusion_map' [B, 1, h, w]
        (when estimated), 'mask' [B, K+1, h, w] and 'sparse_deformed'
        [B, K+1, h, w, C]."""
        src = antialias_downsample(source_image.permute(0, 2, 3, 1),
                                   self.scale_factor).contiguous()
        Bs, h, w, C = src.shape
        B = kp_driving["value"].shape[0]
        if B % Bs:
            raise ValueError(f"source batch {Bs} must divide keypoint "
                             f"batch {B}")
        K = self.num_kp
        heatmap = (kp2gaussian(kp_driving["value"], (h, w), self.kp_variance)
                   - kp2gaussian(kp_source["value"], (h, w), self.kp_variance))
        heatmap = torch.cat([heatmap.new_zeros(B, 1, h, w), heatmap], dim=1)

        motions = sparse_motions((h, w), kp_driving["value"],
                                 kp_source["value"],
                                 kp_driving.get("jacobian"),
                                 kp_source.get("jacobian"))    # [B,K+1,h,w,2]
        deformed = grid_sample_narrow(
            src, motions.reshape(B * (K + 1), h, w, 2)
        ).view(B, K + 1, h, w, C)

        # channel kp*(C+1) + {0: heatmap, 1..C: deformed copy}
        hg_in = torch.cat([heatmap[:, :, None],
                           deformed.permute(0, 1, 4, 2, 3)], dim=2)
        prediction = self.hourglass(hg_in.reshape(B, (K + 1) * (C + 1), h, w))

        mask_raw, occlusion_raw = self.heads(prediction)
        mask = torch.softmax(mask_raw, dim=1)                   # [B,K+1,h,w]
        deformation = torch.einsum("bkhw,bkhwc->bhwc", mask, motions)
        out = {"mask": mask, "sparse_deformed": deformed,
               "deformation": deformation}
        if occlusion_raw is not None:
            out["occlusion_map"] = torch.sigmoid(occlusion_raw)
        return out

    def _head_convs(self) -> list:
        return [c for c in (self.mask, self.occlusion) if c is not None]

    def _fold_sources(self) -> list:
        return [p for c in self._head_convs() for p in (c.weight, c.bias)]

    def _fold(self) -> dict:
        convs = self._head_convs()
        w, self.heads_pads_r, self.heads_pads_c = fold_conv_kernel_s2d(
            torch.cat([c.weight for c in convs]), HEADS_BLOCK)
        return {"heads_weight": w, "heads_bias": torch.cat(
            [c.bias for c in convs]).repeat_interleave(HEADS_BLOCK ** 2)}

    def heads_literal(self, prediction: torch.Tensor):
        """(mask logits [B, K+1, h, w], occlusion logits [B, 1, h, w] or
        None) by the two 7x7 convs."""
        return (self.mask(prediction), None if self.occlusion is None
                else self.occlusion(prediction))

    def heads_s2d(self, prediction: torch.Tensor):
        """``heads_literal`` as one ``conv_s2d`` over both heads' folded
        weights, split."""
        w, b = self.folded("heads_weight", "heads_bias")
        y = conv_s2d_folded(prediction, w, self.heads_pads_r,
                            self.heads_pads_c, HEADS_BLOCK, b)
        K1 = self.num_kp + 1
        return y[:, :K1], (y[:, K1:] if self.occlusion is not None else None)

    def heads(self, prediction: torch.Tensor):
        h, w = prediction.shape[2:]
        if self.training or h % HEADS_BLOCK or w % HEADS_BLOCK:
            return self.heads_literal(prediction)
        return self.heads_s2d(prediction)
