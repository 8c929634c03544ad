"""SUPP: the quantization loss is the point (reward sign), with a
reason."""
import torch


def ship(pipe, frame):
    # torchlint: disable=unguarded-cast -- frames are integral 0..255 upstream, the cast is exact
    q = frame.to(torch.uint8)
    pipe.send(q)
