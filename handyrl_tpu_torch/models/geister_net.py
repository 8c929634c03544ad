"""Policy-value-return DRC network for Geister.

The counterpart of ``handyrl_tpu.models.geister_net``: the scalar
features broadcast onto the board planes (and concatenated before
them), a conv stem with GroupNorm, a 3-layer DRC body repeated 3x, a
move-policy head (4 directions x 36 cells), a 70-way piece-layout set
head driven by the turn-color scalar alone, a tanh value head and an
unsquashed return head.

The public input is the env's observation dict ``{"scalar": (B, 18),
"board": (B, 6, 6, 7)}`` (channel-last) and the hidden dict of
:mod:`.recurrent`; the board is seen as NCHW inside.  The move logits
are flattened direction-major, ``d * 36 + x * 6 + y``: the NCHW
flatten of the 4 direction planes, which is the Flax net's transpose
of its NHWC planes.
"""

import torch
import torch.nn.functional as F
from torch import nn

from .blocks import ValueHead, group_norm
from .recurrent import DRC, to_nchw

BOARD = (6, 6)
CELLS = BOARD[0] * BOARD[1]
SCALAR_FEATURES = 18
BOARD_PLANES = 7
NUM_MOVE_ACTIONS = 4 * CELLS
NUM_SET_ACTIONS = 70


class GeisterNet(nn.Module):
    def __init__(self, filters=32, drc_layers=3, drc_repeats=3):
        super().__init__()
        self.config = {"filters": int(filters),
                       "drc_layers": int(drc_layers),
                       "drc_repeats": int(drc_repeats)}
        self.stem = nn.Conv2d(SCALAR_FEATURES + BOARD_PLANES, filters, 3,
                              padding=1, bias=False)
        self.stem_norm = group_norm(filters)
        self.drc = DRC(drc_layers, filters, filters,
                       num_repeats=drc_repeats)
        self.move_conv = nn.Conv2d(filters, 8, 3, padding=1, bias=False)
        self.move_norm = group_norm(8)
        self.move_out = nn.Conv2d(8, 4, 1, bias=False)
        self.set_head = nn.Linear(1, NUM_SET_ACTIONS)
        self.value = ValueHead(filters, bottleneck=2, cells=CELLS)
        self.ret = ValueHead(filters, bottleneck=2, cells=CELLS,
                             squash=False)

    def init_hidden(self, batch_shape=(), device=None):
        return DRC.initial_state(self.config["drc_layers"], BOARD,
                                 self.config["filters"], batch_shape, device)

    def forward(self, obs, hidden=None):
        board, scalar = obs["board"], obs["scalar"]  # (B,6,6,7), (B,18)
        n = board.shape[0]
        if hidden is None:
            hidden = self.init_hidden((n,), board.device)
        s_planes = scalar[:, :, None, None].expand(
            (n, scalar.shape[1]) + BOARD)
        h = torch.cat([s_planes, to_nchw(board)], dim=1)
        h = F.relu(self.stem_norm(self.stem(h)))

        h, new_hidden = self.drc(h, hidden)

        pm = F.relu(self.move_norm(self.move_conv(h)))
        pm = self.move_out(pm).reshape(n, NUM_MOVE_ACTIONS)
        ps = self.set_head(scalar[:, :1])
        return {"policy": torch.cat([pm, ps], dim=1),
                "value": self.value(h), "return": self.ret(h),
                "hidden": new_hidden}
