"""Torus-convolution residual policy-value net for Hungry Geese.

The counterpart of ``handyrl_tpu.models.geese_net``: wrap-around
padding so convs see the board's toroidal topology, a 32-filter stem +
12 residual blocks, a policy head read from the goose's head cell and a
value head from [head features, board-average features].

The public input is the env's channel-last observation ``(B, 7, 11,
17)``, as for the Flax net; it is permuted to NCHW once at the top.
``TorusConv`` is a circular pad on H and W (``jnp.pad(mode="wrap")``
in the Flax net) followed by a conv with no padding.
"""

import torch
import torch.nn.functional as F
from torch import nn

from .blocks import group_norm

OBS_PLANES = 17


class TorusConv(nn.Module):
    """Conv with wrap-around (toroidal) padding, then GroupNorm."""

    def __init__(self, in_channels, filters, kernel=3, use_norm=True):
        super().__init__()
        self.pad = kernel // 2
        self.conv = nn.Conv2d(in_channels, filters, kernel, padding=0,
                              bias=not use_norm)
        self.norm = group_norm(filters) if use_norm else None

    def forward(self, x):
        e = self.pad
        h = self.conv(F.pad(x, (e, e, e, e), mode="circular"))
        if self.norm is not None:
            h = self.norm(h)
        return h


class GeeseNet(nn.Module):
    def __init__(self, filters=32, blocks=12):
        super().__init__()
        self.config = {"filters": int(filters), "blocks": int(blocks)}
        self.stem = TorusConv(OBS_PLANES, filters)
        self.blocks = nn.ModuleList(
            TorusConv(filters, filters) for _ in range(blocks))
        self.policy = nn.Linear(filters, 4, bias=False)
        self.value = nn.Linear(2 * filters, 1, bias=False)

    def forward(self, obs, hidden=None):
        # obs: (B, 7, 11, 17) channel-last; plane 0 marks the head cell
        x = obs.permute(0, 3, 1, 2).contiguous()
        h = F.relu(self.stem(x))
        for block in self.blocks:
            h = F.relu(h + block(h))

        head_mask = x[:, :1]                          # (B, 1, 7, 11)
        h_head = (h * head_mask).sum(dim=(2, 3))      # (B, C)
        h_avg = h.mean(dim=(2, 3))                    # (B, C)

        policy = self.policy(h_head)
        value = torch.tanh(self.value(torch.cat([h_head, h_avg], dim=1)))
        return {"policy": policy, "value": value}
