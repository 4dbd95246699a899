"""Occlusion-aware generator (NCHW), split as in the JAX package.

Counterpart of ``eamm_tpu/models/generator.py``: ``encode_source`` runs
once per source image, ``decode`` once per batch of frames.  Decode is
shared-source: the source batch Bs divides the keypoint batch B and frame
b reads source b // (B // Bs), in dense motion and in the bottleneck warp,
so the encoded features are never repeated per frame.

The bottleneck warp is the wide warp kernel.  ``encode_source`` returns the
features in ``torch.channels_last`` memory format, so their NHWC view is
the contiguous image the kernel reads, and the kernel's NHWC output, seen
as NCHW, is again channels_last: the bottleneck needs no layout copy.

In eval, at sizes divisible by 4, the final 7x7 conv (64 -> 3 channels)
runs as ``conv_s2d_strided`` (block 4) from a kernel folded once per load,
as the JAX module does: on an NVIDIA H100 80GB HBM3 at 700 W, 5.28 ms of a
neutral 10 s request against the literal conv's 18.52 (``chip_profile.py``
``conv_forms``).
"""
from __future__ import annotations

import torch
import torch.nn as nn

from eamm_tpu_torch.models.blocks import (DownBlock, FoldedWeights, ResBlock,
                                          SameBlock, UpBlock)
from eamm_tpu_torch.models.dense_motion import DenseMotionNetwork
from eamm_tpu_torch.ops.subpixel import (conv_s2d_strided,
                                         fold_conv_kernel_s2d_strided)
from eamm_tpu_torch.ops.warp import resize_bilinear
from eamm_tpu_torch.ops.warp_cuda import grid_sample_wide


FINAL_BLOCK = 4          # of the final conv's eval form


class OcclusionAwareGenerator(FoldedWeights, nn.Module):
    def __init__(self, num_channels: int = 3, num_kp: int = 10,
                 block_expansion: int = 64, max_features: int = 512,
                 num_down_blocks: int = 2, num_bottleneck_blocks: int = 6,
                 estimate_occlusion_map: bool = True,
                 dense_motion_params: dict | None = None):
        super().__init__()
        if dense_motion_params is None:
            raise ValueError("the render path needs dense_motion_params")
        self.dense_motion_network = DenseMotionNetwork(
            num_kp=num_kp, num_channels=num_channels,
            estimate_occlusion_map=estimate_occlusion_map,
            **dense_motion_params)
        width = [min(max_features, block_expansion * (2 ** i))
                 for i in range(num_down_blocks + 1)]
        self.first = SameBlock(num_channels, block_expansion, 7, 3)
        self.down_blocks = nn.ModuleList(
            DownBlock(width[i], width[i + 1]) for i in range(num_down_blocks))
        self.bottleneck = nn.ModuleDict(
            {f"r{i}": ResBlock(width[-1]) for i in range(num_bottleneck_blocks)})
        self.up_blocks = nn.ModuleList(
            UpBlock(width[num_down_blocks - i], width[num_down_blocks - i - 1])
            for i in range(num_down_blocks))
        self.final = nn.Conv2d(block_expansion, num_channels, 7, padding=3)

    def encode_source(self, source_image: torch.Tensor) -> torch.Tensor:
        """[Bs, C, H, W] -> bottleneck features [Bs, F, H/4, W/4]
        (channels_last)."""
        out = self.first(source_image)
        for block in self.down_blocks:
            out = block(out)
        return out.contiguous(memory_format=torch.channels_last)

    def decode(self, source_image: torch.Tensor,
               source_features: torch.Tensor, kp_driving: dict,
               kp_source: dict, aux: dict | None = None) -> torch.Tensor:
        """Frames [B, C, H, W] in [0, 1] for keypoint batch B.  A dict
        passed as ``aux`` receives dense motion's outputs ('mask',
        'sparse_deformed', 'deformation', 'occlusion_map'), which the
        training visualizer draws."""
        B = kp_driving["value"].shape[0]
        if B % source_features.shape[0]:
            raise ValueError(f"feature batch {source_features.shape[0]} must "
                             f"divide keypoint batch {B}")
        motion = self.dense_motion_network(source_image, kp_driving, kp_source)
        if aux is not None:
            aux.update(motion)
        feats = source_features.permute(0, 2, 3, 1)             # NHWC view
        deformation = resize_bilinear(motion["deformation"], feats.shape[1:3])
        out = grid_sample_wide(feats.contiguous(), deformation)
        out = out.permute(0, 3, 1, 2)                           # NCHW view
        occlusion = motion.get("occlusion_map")
        if occlusion is not None:
            if occlusion.shape[2:] != out.shape[2:]:
                occlusion = resize_bilinear(occlusion.permute(0, 2, 3, 1),
                                            out.shape[2:]).permute(0, 3, 1, 2)
            out = out * occlusion
        for block in self.bottleneck.values():
            out = block(out)
        for block in self.up_blocks:
            out = block(out)
        return torch.sigmoid(self.final_conv(out))

    def _fold_sources(self) -> list:
        return [self.final.weight, self.final.bias]

    def _fold(self) -> dict:
        return {"final_weight": fold_conv_kernel_s2d_strided(
                    self.final.weight, FINAL_BLOCK),
                "final_bias": self.final.bias.repeat_interleave(
                    FINAL_BLOCK ** 2)}

    def final_strided(self, out: torch.Tensor) -> torch.Tensor:
        """``self.final(out)`` as one stride-4 conv with the phase-expanded
        kernel, then depth-to-space."""
        w, b = self.folded("final_weight", "final_bias")
        return conv_s2d_strided(out, w, FINAL_BLOCK, b, folded=True)

    def final_conv(self, out: torch.Tensor) -> torch.Tensor:
        H, W = out.shape[2:]
        if self.training or H % FINAL_BLOCK or W % FINAL_BLOCK:
            return self.final(out)
        return self.final_strided(out)
