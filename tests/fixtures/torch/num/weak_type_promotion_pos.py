"""POS: a Python scalar wrapped in a 1-element tensor drags bf16 up."""
import torch

# torch.tensor([0.1]) has a dimension and the default dtype, float32


def forward(x):
    h = x.to(torch.bfloat16)
    step = torch.tensor([0.1])
    return h * step


def forward_full(x):
    h = x.to(torch.bfloat16)
    return h + torch.full((x.shape[-1],), 0.5)  # torch-only: full()
