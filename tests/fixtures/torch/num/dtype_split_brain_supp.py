"""SUPP: the split is the mixed-precision contract, with a reason."""
import torch


def pack(x):
    # torchlint: disable=dtype-split-brain -- hidden is bf16 compute, value head is a deliberate fp32 island
    return {"hidden": x.to(torch.bfloat16),
            "value": x.to(torch.float32)}
