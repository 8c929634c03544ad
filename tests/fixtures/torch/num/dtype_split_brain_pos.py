"""POS: one returned dict mixes bf16 and fp32 leaves."""
import torch


def pack(x):
    return {"hidden": x.to(torch.bfloat16),
            "value": x.float()}
