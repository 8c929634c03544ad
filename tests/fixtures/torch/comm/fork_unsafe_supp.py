"""Suppressed: the fork in a CUDA module carries a reasoned suppression."""

import multiprocessing as mp

import torch


def spawn_helper(target):
    # torchlint: disable=fork-unsafe -- the child runs CPU-only code and never touches torch.cuda
    proc = mp.Process(target=target)
    proc.start()
    return proc


def warm_up():
    return torch.zeros(1, device="cuda")
