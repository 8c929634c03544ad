"""NEG: every leaf of the returned dict shares one dtype."""
import torch


def pack(x):
    return {"hidden": x.to(torch.bfloat16),
            "value": x.bfloat16()}
