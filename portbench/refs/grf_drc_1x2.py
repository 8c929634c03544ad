"""Plain float32 reference of GRFNet on the GRF super-minimap raster.

A recurrent policy-value net for the (72, 96, 16) SMM planes (Kurach et
al., arXiv:1907.11180), as the repository's GRF drill defines it: two
3 x 3 stride-2 convolutions (no bias; XLA "SAME" padding, the smaller
half first, so an even side pads 0 before and 1 after), each followed
by GroupNorm (8 groups, epsilon 1e-6) and ReLU, take 72 x 96 to 18 x
24; a DRC core (Guez et al., arXiv:1901.03559: ``drc_layers`` ConvLSTM
cells applied ``drc_repeats`` times per step, layer ``i > 0`` reading
layer ``i - 1``'s new state) whose gates come from one 3 x 3 convolution
with bias over ``[input, h]``, split ``i, f, o, g``; then a policy head
and a tanh value head, each a 1 x 1 convolution to 2 channels, leaky
ReLU (slope 0.1), and a linear layer (no bias) over the features
flattened in (h, w, c) order.  Input ``(N, 72, 96, 16)`` channel-last;
the hidden state ``{"h0", "c0", ...}`` is kept NCHW here.

``q`` rounds what enters a convolution or a linear layer (``q(x)``),
the gradient leaving it (``q.out(y)``) and the cell's gates and state,
which the program computes in its bfloat16 (``q.val``): exact for the
reference, a lower precision for the control (``refs/train.py``).
"""

import torch
import torch.nn.functional as F

RECURRENT = True
CORE = (18, 24)


def groups(channels, target=8):
    return max(g for g in range(1, target + 1) if channels % g == 0)


def same_pad(size, kernel=3, stride=2):
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


def init_hidden(n, net, device):
    shape = (n, net["filters"]) + CORE
    return {f"{k}{i}": torch.zeros(shape, device=device)
            for i in range(net["drc_layers"]) for k in ("h", "c")}


def _head(p, name, x, q):
    h = F.leaky_relu(q.out(F.conv2d(q(x), q(p[f"{name}.conv.weight"]),
                                    p[f"{name}.conv.bias"])), 0.1)
    h = h.permute(0, 2, 3, 1).reshape(h.shape[0], -1)
    return q.out(F.linear(q(h), q(p[f"{name}.fc.weight"])))


def forward(p, obs, hidden, net, q):
    """``(policy (N, 9), value (N, 1), new hidden)``."""
    ngroups = groups(net["filters"])
    x = obs.permute(0, 3, 1, 2)
    for i in range(2):
        top, bottom = same_pad(x.shape[2])
        left, right = same_pad(x.shape[3])
        x = q.out(F.conv2d(q(F.pad(x, (left, right, top, bottom))),
                           q(p[f"stem.{i}.weight"]), stride=2))
        x = F.relu(F.group_norm(x, ngroups, p[f"stem_norm.{i}.weight"],
                                p[f"stem_norm.{i}.bias"], 1e-6))
    L = net["drc_layers"]
    hs = [hidden[f"h{i}"] for i in range(L)]
    cs = [hidden[f"c{i}"] for i in range(L)]
    for _ in range(net["drc_repeats"]):
        for i in range(L):
            inp = hs[i - 1] if i > 0 else x
            gates = q.out(F.conv2d(q(torch.cat([inp, hs[i]], 1)),
                                   q(p[f"drc.cells.{i}.conv.weight"]),
                                   p[f"drc.cells.{i}.conv.bias"],
                                   padding=1))
            gi, gf, go, gg = gates.chunk(4, dim=1)
            v = q.val
            cs[i] = v(v(torch.sigmoid(gf)) * cs[i]
                      + v(torch.sigmoid(gi)) * v(torch.tanh(gg)))
            hs[i] = v(v(torch.sigmoid(go)) * v(torch.tanh(cs[i])))
    new = {}
    for i in range(L):
        new[f"h{i}"], new[f"c{i}"] = hs[i], cs[i]
    policy = _head(p, "policy", hs[-1], q)
    value = torch.tanh(_head(p, "value", hs[-1], q))
    return policy, value, new
