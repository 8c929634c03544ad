"""SUPP: an intentional fp32 island, suppressed with a reason."""
import torch


def forward(x):
    h = x.to(torch.bfloat16)
    scale = torch.ones(x.shape[-1])
    # deliberate fp32 island: the final head runs full precision
    # torchlint: disable=implicit-upcast -- fp32 head is the mixed-precision boundary
    return h * scale
