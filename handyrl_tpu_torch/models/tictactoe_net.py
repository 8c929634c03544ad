"""Policy-value convnet for Tic-Tac-Toe.

The counterpart of ``handyrl_tpu.models.tictactoe_net``: a SAME-padded
stem conv + 3 conv blocks at 32 filters, a 9-way policy head and a
tanh value head.  Input is the env's channel-last ``(B, 3, 3, 3)``
observation, permuted to NCHW at the top.
"""

import torch.nn.functional as F
from torch import nn

from .blocks import ConvBlock, PolicyHead, ValueHead

OBS_PLANES = 3
CELLS = 9


class TicTacToeNet(nn.Module):
    def __init__(self, filters=32, blocks=3):
        super().__init__()
        self.config = {"filters": int(filters), "blocks": int(blocks)}
        self.stem = nn.Conv2d(OBS_PLANES, filters, 3, padding=1)
        self.blocks = nn.ModuleList(
            ConvBlock(filters, filters) for _ in range(blocks))
        self.policy = PolicyHead(filters, bottleneck=2, num_actions=9,
                                 cells=CELLS)
        self.value = ValueHead(filters, bottleneck=1, cells=CELLS)

    def forward(self, obs, hidden=None):
        h = F.relu(self.stem(obs.permute(0, 3, 1, 2).contiguous()))
        for block in self.blocks:
            h = block(h)
        return {"policy": self.policy(h), "value": self.value(h)}
