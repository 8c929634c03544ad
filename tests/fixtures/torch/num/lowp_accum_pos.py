"""POS: a reduction told to accumulate in bf16, and a bf16 carry."""
import torch

# (a bf16 matmul accumulates in fp32 on the card: see the negative)


def attention(q, k):
    scores = torch.matmul(q, k)
    # the input is rounded to bf16 before the sum:
    return torch.sum(scores, dtype=torch.bfloat16)


def scan(xs):
    acc = torch.zeros(4, dtype=torch.bfloat16)
    for x in xs:
        acc = acc + x.to(torch.bfloat16)  # torch-only: a bf16 carry
    return acc
