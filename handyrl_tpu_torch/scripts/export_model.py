"""Export a checkpoint as a numpy ``.npz`` archive.

The twin of ``scripts/export_model.py``: flat-named parameters
(``a/b/kernel``) plus a JSON header (env name, epoch, flat key order),
loadable with nothing but numpy and read back by either package's
``load_model``.  No device work.

Usage: python -m handyrl_tpu_torch.scripts.export_model [model.ckpt]
       [out.npz]
"""

import json
import os
import sys

import numpy as np
import yaml

from ..durability import read_verified
from ..utils.tree import flatten_params


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    ckpt = argv[0] if len(argv) > 0 else "models/latest.ckpt"
    out = argv[1] if len(argv) > 1 else (
        os.path.splitext(ckpt)[0] + ".npz")

    with open("config.yaml") as f:
        env_name = yaml.safe_load(f)["env_args"]["env"]

    state = read_verified(ckpt)
    flat = flatten_params(state["params"])
    header = json.dumps({
        "env": env_name,
        "epoch": state.get("epoch", -1),
        "keys": list(flat),
    })
    np.savez(out, __header__=np.frombuffer(
        header.encode(), dtype=np.uint8), **flat)
    print(f"wrote {out} ({len(flat)} tensors)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
