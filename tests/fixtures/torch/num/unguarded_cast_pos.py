"""POS: a lossy uint8 quantization escapes over a pipe unchecked."""
import torch


def ship(pipe, frame):
    q = frame.to(torch.uint8)
    pipe.send(q)


def ship_bytes(pipe, frame):
    pipe.send(frame.byte())  # torch-only: the .byte() spelling
