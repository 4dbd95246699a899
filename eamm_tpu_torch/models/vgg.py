"""VGG19 features of the fine-tune perceptual loss (NCHW).

Counterpart of ``eamm_tpu/models/vgg.py``: torchvision's ``vgg19.features``
up to the ReLU at index 29, with ImageNet normalization of the [0, 1]
input in front, returning the five after-ReLU feature maps at the cut
points 2, 7, 12, 21 and 30.  The layers keep torchvision's ``features.<i>``
names, so ``load_torchvision`` takes a torchvision ``vgg19`` state_dict as
it is (the layers past index 29 and the classifier are not held).
"""
from __future__ import annotations

from typing import Mapping

import torch
import torch.nn as nn

# torchvision vgg19.features up to index 28: each conv's output channels
# (a ReLU follows each), 'M' the 2x2 max pools (indices 4, 9, 18 and 27)
_LAYERS = (64, 64, "M", 128, 128, "M", 256, 256, 256, 256, "M",
           512, 512, 512, 512, "M", 512)
CUTS = (2, 7, 12, 21, 30)          # after-ReLU slice ends (exclusive)

_MEAN = (0.485, 0.456, 0.406)
_STD = (0.229, 0.224, 0.225)


class Vgg19(nn.Module):
    """x [B, 3, H, W] in [0, 1] -> list of the five feature maps."""

    def __init__(self):
        super().__init__()
        layers: list[nn.Module] = []
        cin = 3
        for item in _LAYERS:
            if item == "M":
                layers.append(nn.MaxPool2d(2, 2))
            else:
                layers += [nn.Conv2d(cin, item, 3, padding=1), nn.ReLU()]
                cin = item
        self.features = nn.Sequential(*layers)
        self.register_buffer("mean", torch.tensor(_MEAN).view(1, 3, 1, 1),
                             persistent=False)
        self.register_buffer("std", torch.tensor(_STD).view(1, 3, 1, 1),
                             persistent=False)

    def forward(self, x: torch.Tensor) -> list[torch.Tensor]:
        h = (x - self.mean.to(x.dtype)) / self.std.to(x.dtype)
        outs = []
        start = 0
        for end in CUTS:
            for layer in self.features[start:end]:
                h = layer(h)
            outs.append(h)
            start = end
        return outs

    def load_torchvision(self, state_dict: Mapping) -> None:
        """Load a torchvision ``vgg19`` state_dict: the ``features`` convs
        this module holds, nothing else."""
        own = self.state_dict()
        self.load_state_dict({k: v for k, v in state_dict.items()
                              if k in own})
