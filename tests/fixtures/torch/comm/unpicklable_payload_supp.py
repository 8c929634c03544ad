"""Suppressed: the CUDA-tensor send carries a reasoned suppression."""

import torch


def ship_device(conn):
    arr = torch.zeros((4,), device="cuda")
    # torchlint: disable=unpicklable-payload -- same-host pipe to a child that owns the same card; torch's CUDA IPC shares the storage
    conn.send(arr)
