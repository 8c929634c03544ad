"""SUPP: bf16 accumulation accepted for this op, with a reason."""
import torch


def attention(q, k):
    scores = torch.matmul(q, k)
    # torchlint: disable=lowp-accum -- contraction dim is 64; bf16 error is below the logit noise floor
    return torch.sum(scores, dtype=torch.bfloat16)
