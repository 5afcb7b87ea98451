"""ResNet-18 encoder with GroupNorm.

Port of ``videocad_tpu/models/resnet.py``: torchvision's resnet18 layout
with every BatchNorm a GroupNorm of ``min(32, C)`` groups (eps 1e-5, the
value the JAX module sets; flax's default is 1e-6) and the classification
head stripped, giving a (B, 512) embedding: the mean over H and W of the
last stage.

The parameter names follow the JAX tree (``stem_conv``, ``stem_gn``,
``stage{s}_block{b}.conv1 / gn1 / conv2 / gn2 / downsample_conv /
downsample_gn``); a convolution's weight is OIHW (``models/convert.py``
maps flax's HWIO). The convolutions have no bias; the 3 x 3 ones pad 1,
the 7 x 7 stem pads 3, the 1 x 1 downsample pads nothing, and the max-pool
is 3 x 3, stride 2, padding 1.

The input is NHWC, as the model gives it: one permute makes it an NCHW
view in ``channels_last`` memory, the layout the convolutions then keep.
The flax module infers its input channels at the first call; this one is
told them (``in_channels``: 1 for grayscale frames, 3 for a GenCAD CAD
image). Convolutions run in the compute dtype through ``F.conv2d``;
GroupNorm takes its statistics in float32 through ``F.group_norm`` and
returns the compute dtype, as flax's GroupNorm does. The JAX package
computes both through XLA, outside any Pallas kernel, so they are library
calls here too. ``remat=True`` (the state encoder under ``remat_encoder``)
recomputes the stem and each block in the backward instead of keeping
their activations.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from videocad_tpu_torch.models.layers import remat

GN_EPS = 1e-5


class Conv(nn.Module):
    """A bias-free convolution, weight (out, in, kh, kw) in float32,
    computed in the compute dtype."""

    def __init__(self, in_channels: int, out_channels: int, kernel: int,
                 stride: int = 1, padding: int = 0,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        self.dtype = dtype
        self.stride = stride
        self.padding = padding
        self.weight = nn.Parameter(torch.empty(
            out_channels, in_channels, kernel, kernel, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.conv2d(x.to(self.dtype), self.weight.to(self.dtype),
                        stride=self.stride, padding=self.padding)


class GroupNorm(nn.Module):
    """flax ``nn.GroupNorm``: float32 statistics and affine, eps 1e-5,
    output in the compute dtype."""

    def __init__(self, channels: int, groups: int,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        self.dtype = dtype
        self.groups = groups
        self.weight = nn.Parameter(torch.ones(channels, device=device))
        self.bias = nn.Parameter(torch.zeros(channels, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.group_norm(x.to(torch.float32), self.groups, self.weight,
                         self.bias, GN_EPS)
        return y.to(self.dtype)


def _gn(channels: int, **kw) -> GroupNorm:
    return GroupNorm(channels, min(32, channels), **kw)


class BasicBlock(nn.Module):
    """Two 3 x 3 convolutions with GroupNorm, and a 1 x 1 projection of
    the residual where the width or the stride changes."""

    def __init__(self, in_channels: int, features: int, stride: int = 1,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.conv1 = Conv(in_channels, features, 3, stride, 1, **kw)
        self.gn1 = _gn(features, **kw)
        self.conv2 = Conv(features, features, 3, 1, 1, **kw)
        self.gn2 = _gn(features, **kw)
        self.project = in_channels != features or stride != 1
        if self.project:
            self.downsample_conv = Conv(in_channels, features, 1, stride,
                                        **kw)
            self.downsample_gn = _gn(features, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(self.gn1(self.conv1(x)))
        y = self.gn2(self.conv2(y))
        residual = x
        if self.project:
            residual = self.downsample_gn(self.downsample_conv(x))
        return F.relu(y + residual)


class ResNet18GN(nn.Module):
    """(B, H, W, C) image -> (B, 512) embedding."""

    stage_sizes = (2, 2, 2, 2)
    widths = (64, 128, 256, 512)

    def __init__(self, in_channels: int = 1,
                 dtype: torch.dtype = torch.float32, device=None,
                 remat: bool = False):
        super().__init__()
        self.dtype = dtype
        self.remat = remat
        kw = dict(dtype=dtype, device=device)
        self.stem_conv = Conv(in_channels, 64, 7, 2, 3, **kw)
        self.stem_gn = GroupNorm(64, 32, **kw)
        channels = 64
        for stage, (blocks, width) in enumerate(zip(self.stage_sizes,
                                                    self.widths)):
            for block in range(blocks):
                stride = 2 if stage > 0 and block == 0 else 1
                self.add_module(f"stage{stage}_block{block}", BasicBlock(
                    channels, width, stride, **kw))
                channels = width

    def forward(self, images: torch.Tensor, rng: Optional[object] = None
                ) -> torch.Tensor:
        """``rng`` is accepted for the encoders' common call and unused:
        the ResNet has no dropout."""
        # With remat, the stem and each block are recomputed in the
        # backward, one at a time (models/layers.py:remat).
        x = (remat(self, images, method=self._stem) if self.remat
             else self._stem(images))
        for stage, blocks in enumerate(self.stage_sizes):
            for block in range(blocks):
                module = getattr(self, f"stage{stage}_block{block}")
                x = remat(module, x) if self.remat else module(x)
        return x.mean(dim=(2, 3))

    def _stem(self, images: torch.Tensor) -> torch.Tensor:
        # NHWC -> an NCHW view whose memory is channels_last.
        x = images.to(self.dtype).permute(0, 3, 1, 2)
        x = F.relu(self.stem_gn(self.stem_conv(x)))
        return F.max_pool2d(x, 3, stride=2, padding=1)
