"""POS: bf16 activations silently upcast by a dimensioned fp32 tensor."""
import torch

# torch promotes bf16 * fp32 to fp32 when the fp32 side has a
# dimension (a Python scalar or a 0-dim tensor would not)


def forward(x):
    h = x.to(torch.bfloat16)
    scale = torch.ones(x.shape[-1])
    return h * scale


def forward_master(x):
    h = x.bfloat16()
    return h + x.float()  # torch-only: the fp32 master copy mixed in
