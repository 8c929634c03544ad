"""Plain float32 reference of GeeseNet (HandyRL's Hungry Geese net).

Written from the published description (DeNA/HandyRL,
``handyrl/envs/kaggle/hungry_geese.py``): a 3 x 3 "torus" convolution
(wrap-around padding, no bias) + normalization + ReLU stem, ``blocks``
residual blocks ``h = relu(h + norm(tconv(h)))``, a 4-way policy from
the features summed over the goose's head cell, and a tanh value from
``[head features, board-mean features]``.  Departure, as in the ported
program: GroupNorm (8 groups of contiguous channels, epsilon 1e-6) in
place of BatchNorm.  Input ``(N, 7, 11, 17)`` channel-last.

``q`` rounds what enters a convolution or a linear layer (``q(x)``) and
the gradient leaving it (``q.out(y)``): exact for the reference, a lower
precision for the control (``refs/train.py``).
"""

import torch
import torch.nn.functional as F

RECURRENT = False


def groups(channels, target=8):
    return max(g for g in range(1, target + 1) if channels % g == 0)


def _tconv(p, name, h, q, ngroups):
    h = F.pad(h, (1, 1, 1, 1), mode="circular")
    h = q.out(F.conv2d(q(h), q(p[f"{name}.conv.weight"])))
    return F.group_norm(h, ngroups, p[f"{name}.norm.weight"],
                        p[f"{name}.norm.bias"], 1e-6)


def forward(p, obs, hidden, net, q):
    """``(policy (N, 4), value (N, 1), None)``."""
    ngroups = groups(net["filters"])
    x = obs.permute(0, 3, 1, 2)
    h = F.relu(_tconv(p, "stem", x, q, ngroups))
    for i in range(net["blocks"]):
        h = F.relu(h + _tconv(p, f"blocks.{i}", h, q, ngroups))
    h_head = (h * x[:, :1]).sum(dim=(2, 3))
    h_avg = h.mean(dim=(2, 3))
    policy = q.out(F.linear(q(h_head), q(p["policy.weight"])))
    value = torch.tanh(q.out(F.linear(q(torch.cat([h_head, h_avg], 1)),
                                      q(p["value.weight"]))))
    return policy, value, None
