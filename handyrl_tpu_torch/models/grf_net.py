"""Recurrent policy-value net for GRF-scale observations.

The counterpart of ``handyrl_tpu.models.grf_net``, the net of the
GRFProxy drill at the real GRF raster, (72, 96, 16) planes: two
stride-2 3x3 conv stages (each GroupNorm + ReLU) shrink 72x96 to 18x24
before the recurrent core, a 1-layer DRC repeated twice, then a 9-way
policy head and a tanh value head.

Flax's ``padding="SAME"`` at stride 2 pads asymmetrically: the total
pad ``max((ceil(n/2) - 1) * 2 + 3 - n, 0)`` puts its smaller half
first, so an even side (72, 96, 36, 48) gets 0 rows before and 1
after.  ``nn.Conv2d(stride=2, padding=1)`` pads 1 on both sides: the
same output shape, other pixels.  The stem therefore pads explicitly
(:func:`same_pad`) and convolves with ``padding=0``.
"""

import torch.nn.functional as F
from torch import nn

from .blocks import PolicyHead, ValueHead, group_norm
from .recurrent import DRC, to_nchw

FIELD = (72, 96)
CORE = (18, 24)          # field / 4 after the strided stem
OBS_PLANES = 16
NUM_ACTIONS = 9          # 8 directions + stay


def same_pad(size, kernel=3, stride=2):
    """``(before, after)`` padding of XLA's SAME along one side."""
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


class GRFNet(nn.Module):
    def __init__(self, filters=32, drc_layers=1, drc_repeats=2):
        super().__init__()
        self.config = {"filters": int(filters),
                       "drc_layers": int(drc_layers),
                       "drc_repeats": int(drc_repeats)}
        self.stem = nn.ModuleList([
            nn.Conv2d(OBS_PLANES, filters, 3, stride=2, bias=False),
            nn.Conv2d(filters, filters, 3, stride=2, bias=False)])
        self.stem_norm = nn.ModuleList(
            [group_norm(filters), group_norm(filters)])
        self.drc = DRC(drc_layers, filters, filters,
                       num_repeats=drc_repeats)
        cells = CORE[0] * CORE[1]
        self.policy = PolicyHead(filters, bottleneck=2,
                                 num_actions=NUM_ACTIONS, cells=cells)
        self.value = ValueHead(filters, bottleneck=2, cells=cells)

    def init_hidden(self, batch_shape=(), device=None):
        return DRC.initial_state(self.config["drc_layers"], CORE,
                                 self.config["filters"], batch_shape, device)

    def forward(self, obs, hidden=None):
        x = obs["board"] if isinstance(obs, dict) else obs
        if hidden is None:
            hidden = self.init_hidden((x.shape[0],), x.device)
        x = to_nchw(x)
        for conv, norm in zip(self.stem, self.stem_norm):
            top, bottom = same_pad(x.shape[2])
            left, right = same_pad(x.shape[3])
            x = F.relu(norm(conv(F.pad(x, (left, right, top, bottom)))))
        x, new_hidden = self.drc(x, hidden)
        return {"policy": self.policy(x), "value": self.value(x),
                "hidden": new_hidden}
