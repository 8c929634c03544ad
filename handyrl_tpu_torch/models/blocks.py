"""Shared torch building blocks for policy-value nets.

Counterparts of ``handyrl_tpu.models.blocks``, held to the Flax
blocks' numerics:

  * GroupNorm, not BatchNorm, with Flax's epsilon 1e-6 (torch's default
    is 1e-5) and the group count from :func:`pick_num_groups`; both
    frameworks group contiguous channels, so channel order survives the
    NHWC -> NCHW permute;
  * SAME padding of an odd kernel is ``padding=kernel // 2``;
  * a conv followed by a norm has no bias, as in the Flax blocks;
  * heads flatten in NHWC ``(h, w, c)`` order, as Flax does, so a
    ``Dense`` kernel carries over to ``nn.Linear`` without a row
    shuffle.

Tensors inside a net are NCHW.
"""

import torch
import torch.nn.functional as F
from torch import nn

GROUPNORM_EPS = 1e-6  # flax.linen.GroupNorm's default epsilon


def pick_num_groups(channels: int, target: int = 8) -> int:
    """Largest divisor of ``channels`` that is <= ``target``."""
    for g in range(min(target, channels), 0, -1):
        if channels % g == 0:
            return g
    return 1


def group_norm(channels: int) -> nn.GroupNorm:
    return nn.GroupNorm(pick_num_groups(channels), channels,
                        eps=GROUPNORM_EPS)


class ConvBlock(nn.Module):
    """3x3 conv (SAME) -> GroupNorm -> ReLU."""

    def __init__(self, in_channels, filters, kernel=3, use_norm=True):
        super().__init__()
        self.conv = nn.Conv2d(in_channels, filters, kernel,
                              padding=kernel // 2, bias=not use_norm)
        self.norm = group_norm(filters) if use_norm else None

    def forward(self, x):
        x = self.conv(x)
        if self.norm is not None:
            x = self.norm(x)
        return F.relu(x)


def _flatten_hwc(h):
    """NCHW -> (N, H*W*C) in the Flax (h, w, c) order."""
    return h.permute(0, 2, 3, 1).reshape(h.shape[0], -1)


class PolicyHead(nn.Module):
    """1x1 conv bottleneck -> leaky ReLU -> flatten -> dense logits."""

    def __init__(self, in_channels, bottleneck, num_actions, cells):
        super().__init__()
        self.conv = nn.Conv2d(in_channels, bottleneck, 1)
        self.fc = nn.Linear(cells * bottleneck, num_actions, bias=False)

    def forward(self, x):
        h = F.leaky_relu(self.conv(x), negative_slope=0.1)
        return self.fc(_flatten_hwc(h))


class ValueHead(nn.Module):
    """1x1 conv bottleneck -> leaky ReLU -> flatten -> dense scalar
    (tanh-squashed unless ``squash`` is off)."""

    def __init__(self, in_channels, bottleneck, cells, outputs=1,
                 squash=True):
        super().__init__()
        self.conv = nn.Conv2d(in_channels, bottleneck, 1)
        self.fc = nn.Linear(cells * bottleneck, outputs, bias=False)
        self.squash = squash

    def forward(self, x):
        h = F.leaky_relu(self.conv(x), negative_slope=0.1)
        h = self.fc(_flatten_hwc(h))
        return torch.tanh(h) if self.squash else h
