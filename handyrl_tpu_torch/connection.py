"""Process fan-out for the port's CPU-side children.

Child processes are SPAWNED, not forked: a parent that holds a CUDA
context cannot fork it into a child, so children start from a fresh
interpreter.  They rebuild models from pickled numpy state and run on
the device their caller names (the CPU for evaluation children).
"""

import multiprocessing as mp

_mp = mp.get_context("spawn")
