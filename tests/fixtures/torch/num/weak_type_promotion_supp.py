"""SUPP: the promotion is wanted here, suppressed with a reason."""
import torch


def forward(x):
    h = x.to(torch.bfloat16)
    step = torch.tensor([0.1])
    # the residual add is the fp32 master-weight path
    # torchlint: disable=weak-type-promotion -- promotion to fp32 is the contract here
    return h * step
