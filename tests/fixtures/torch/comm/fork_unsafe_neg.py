"""Negative: spawn contexts are always safe (fresh interpreter), a
default-context Process BEFORE any threads exist is fine, and so is a
module that only asks whether a card is there."""

import multiprocessing as mp
import threading

import torch

_mp = mp.get_context("spawn")


def spawn_after_threads(target):
    t = threading.Thread(target=target, daemon=True)
    t.start()
    proc = _mp.Process(target=target)    # spawn context: safe
    proc.start()
    return proc


def process_before_threads(target):
    proc = mp.Process(target=target)     # no threads exist yet
    proc.start()
    t = threading.Thread(target=target, daemon=True)
    t.start()
    return proc


def inline_spawn(target):
    proc = mp.get_context("spawn").Process(target=target)
    proc.start()
    return proc, torch.cuda.is_available()
