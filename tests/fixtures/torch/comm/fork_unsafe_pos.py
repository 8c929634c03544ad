"""Positive: forks after threads, under a lock, raw, in a CUDA module."""

import multiprocessing as mp
import os
import threading
import torch


def spawn_after_threads(target):
    t = threading.Thread(target=target, daemon=True)
    t.start()
    proc = mp.Process(target=target)     # fork after threads started
    proc.start()
    return proc


def fork_under_lock(target):
    lock = threading.Lock()
    with lock:
        proc = mp.Process(target=target)  # fork while a lock is held
        proc.start()
    return proc


def raw_fork(handler):
    t = threading.Thread(target=handler, daemon=True)
    t.start()
    pid = os.fork()                      # os.fork after threads
    return pid


def fork_after_cuda(target):
    torch.cuda.init()  # a CUDA context: a forked child cannot re-create it
    proc = mp.Process(target=target)     # torch-only: the CUDA clause
    proc.start()
    return proc
