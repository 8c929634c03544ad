"""NEG: the wrapped scalar is pinned to the compute dtype, or stays
0-dim (torch does not promote a dimensioned bf16 tensor for it)."""
import torch


def forward(x):
    h = x.to(torch.bfloat16)
    step = torch.tensor([0.1], dtype=torch.bfloat16)
    return h * step


def forward_zero_dim(x):
    h = x.to(torch.bfloat16)
    step = torch.tensor(0.1)  # 0-dim: unlike jnp.asarray(0.1), no promotion
    return h * step


def forward_scalar(x):
    h = x.to(torch.bfloat16)
    return h * 0.1
