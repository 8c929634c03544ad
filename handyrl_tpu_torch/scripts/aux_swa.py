"""Stochastic weight averaging over saved epoch checkpoints.

The twin of ``scripts/aux_swa.py``: an equal-weight running mean of
the parameters of ``models/<epoch>.ckpt`` over an epoch range, in
float64, written as float32 to ``models/swa.ckpt``.  The checkpoints
are read with their checksums verified and the result is written in
the checksummed format (:func:`..durability.write_checksummed`), so
both packages' ``--eval`` read it.  No device work.

Usage: python -m handyrl_tpu_torch.scripts.aux_swa <first_epoch>
       <last_epoch> [stride]
"""

import os
import sys

import numpy as np

from ..durability import read_verified, write_checksummed
from ..utils.tree import tree_flatten, tree_map_leaves, tree_unflatten


def average_checkpoints(paths):
    """Float32 params: the float64 running mean over ``paths``."""
    avg, n = None, 0
    for path in paths:
        params = read_verified(path)["params"]
        n += 1
        if avg is None:
            avg = tree_map_leaves(
                lambda a: np.asarray(a, np.float64), params)
            continue
        leaves, treedef = tree_flatten(avg)
        new, new_def = tree_flatten(params)
        if new_def != treedef:
            raise ValueError(f"{path}: parameter tree differs from "
                             f"{paths[0]}")
        # running equal-weight mean
        avg = tree_unflatten(treedef, [
            m + (np.asarray(a, np.float64) - m) / n
            for m, a in zip(leaves, new)])
    return tree_map_leaves(lambda a: np.asarray(a, np.float32), avg)


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    if len(argv) < 2:
        print(__doc__)
        return 1
    first, last = int(argv[0]), int(argv[1])
    stride = int(argv[2]) if len(argv) > 2 else 1

    paths = []
    for epoch in range(first, last + 1, stride):
        path = os.path.join("models", f"{epoch}.ckpt")
        if os.path.exists(path):
            paths.append(path)
    if not paths:
        print("no checkpoints found in range")
        return 1

    print(f"averaging {len(paths)} checkpoints "
          f"({paths[0]} .. {paths[-1]})")
    params = average_checkpoints(paths)
    out = os.path.join("models", "swa.ckpt")
    write_checksummed(out, {"params": params, "epoch": last, "swa": True})
    print(f"wrote {out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
