"""Recurrent building blocks: ConvLSTM and DRC (Deep Repeated ConvLSTM).

The counterpart of ``handyrl_tpu.models.recurrent``: ``num_layers``
ConvLSTM cells applied ``num_repeats`` times per step, layer ``i > 0``
reading layer ``i - 1``'s fresh hidden state (arXiv:1901.03559).

Each cell's gates come from ONE SAME-padded conv with ``4 * hidden``
outputs over the channel concatenation ``[x, h]``, split ``i, f, o, g``
in that order, as in the Flax cell, so a converted kernel lines up
channel for channel.

The public hidden state keeps the JAX package's layout: a flat dict
``{"h0": ..., "c0": ..., "h1": ...}`` whose every leaf is ``(*batch,
H, W, C)``, channel-last, with the batch dims leading.  The loss's mask
algebra and the rollout engines' row writes work on it unchanged.
Inside, a leaf is permuted to NCHW as a view (an NHWC tensor seen as
NCHW is the ``channels_last`` memory format), so the layout change
costs no copy.

The gate math runs in whatever dtype the conv returns: float32
normally, bfloat16 under ``torch.autocast`` (see
:func:`..ops.update.make_apply_fn`, which hands the cell a bfloat16
carry and takes the new one back as float32, as the JAX step does).
"""

import torch
from torch import nn


def to_nchw(x):
    return x.permute(0, 3, 1, 2)


def to_nhwc(x):
    return x.permute(0, 2, 3, 1)


class ConvLSTMCell(nn.Module):
    """One ConvLSTM cell: gates from a single conv over ``[x, h]``."""

    def __init__(self, in_channels, hidden_dim, kernel=3):
        super().__init__()
        self.conv = nn.Conv2d(in_channels + hidden_dim, 4 * hidden_dim,
                              kernel, padding=kernel // 2)

    def forward(self, x, h, c):
        """NCHW ``x``, ``h``, ``c`` -> ``(h', c')``."""
        gates = self.conv(torch.cat([x, h], dim=1))
        i, f, o, g = gates.chunk(4, dim=1)
        c_next = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        h_next = torch.sigmoid(o) * torch.tanh(c_next)
        return h_next, c_next


class DRC(nn.Module):
    """Deep Repeated ConvLSTM: L cells repeated R times per step."""

    def __init__(self, num_layers, in_channels, hidden_dim, kernel=3,
                 num_repeats=3):
        super().__init__()
        self.num_layers = num_layers
        self.num_repeats = num_repeats
        self.cells = nn.ModuleList(
            ConvLSTMCell(in_channels if i == 0 else hidden_dim,
                         hidden_dim, kernel)
            for i in range(num_layers))

    def forward(self, x, hidden):
        """NCHW ``x`` and the NHWC hidden dict of ``(N, H, W, C)``
        leaves -> (NCHW last-layer ``h``, new NHWC hidden dict)."""
        hs = [to_nchw(hidden[f"h{i}"]) for i in range(self.num_layers)]
        cs = [to_nchw(hidden[f"c{i}"]) for i in range(self.num_layers)]
        for _ in range(self.num_repeats):
            for i, cell in enumerate(self.cells):
                inp = hs[i - 1] if i > 0 else x
                hs[i], cs[i] = cell(inp, hs[i], cs[i])
        new_hidden = {}
        for i in range(self.num_layers):
            new_hidden[f"h{i}"] = to_nhwc(hs[i])
            new_hidden[f"c{i}"] = to_nhwc(cs[i])
        return hs[-1], new_hidden

    @staticmethod
    def initial_state(num_layers, spatial, hidden_dim, batch_shape=(),
                      device=None):
        """Zero float32 hidden state; every leaf is ``(*batch, H, W,
        hidden_dim)``."""
        shape = tuple(batch_shape) + tuple(spatial) + (hidden_dim,)
        state = {}
        for i in range(num_layers):
            state[f"h{i}"] = torch.zeros(shape, device=device)
            state[f"c{i}"] = torch.zeros(shape, device=device)
        return state
