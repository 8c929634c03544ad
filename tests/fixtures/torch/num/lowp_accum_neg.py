"""NEG: bf16 inputs, fp32 accumulation — in the kernel, or by hand."""
import torch


def attention(q, k):
    qh = q.to(torch.bfloat16)
    kh = k.to(torch.bfloat16)
    return torch.matmul(qh, kh).sum()  # cuBLAS and sum accumulate in fp32


def scan(xs):
    acc = torch.zeros(4, dtype=torch.float32)
    for x in xs:
        acc = acc + x.float()
    return acc.to(torch.bfloat16)
