"""NEG: the uint8 wire cast is guarded by a round-trip check (the
staging.py obs_store idiom)."""
import torch


def ship(pipe, frame):
    q = frame.to(torch.uint8)
    assert torch.equal(q.float(), frame)
    pipe.send(q)
