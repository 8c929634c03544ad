"""NEG: the fp32 side is cast down, or cannot promote under torch's
rules (a numpy scalar, a 0-dim tensor, a full reduction)."""
import numpy as np
import torch


def forward(x):
    h = x.to(torch.bfloat16)
    scale = torch.ones(x.shape[-1], dtype=torch.bfloat16)
    return h * scale


def forward_numpy_scalar(x):
    h = x.to(torch.bfloat16)
    return h * np.float32(0.5)  # a number to torch: stays bf16


def forward_zero_dim(x):
    h = x.to(torch.bfloat16)
    return h * torch.ones(())  # 0-dim fp32: stays bf16


def forward_reduced(x):
    h = x.to(torch.bfloat16)
    return h + x.float().sum()  # a full reduction is 0-dim
