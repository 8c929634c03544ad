"""Export a checkpoint to ``.onnx``.

The twin of ``scripts/make_onnx_model.py``: the checkpoint is loaded
on ``--device`` (default ``cuda``; a missing card is an error) and the
net's forward is recorded into ONNX ops
(:func:`..interop.onnx_export.export_onnx`).  Recurrent nets unroll
with their hidden state as explicit ``hidden_i`` inputs and
``hidden_out_i`` outputs.  The file runs in either package's numpy
runner:

    python -m handyrl_tpu_torch --eval models/latest.onnx 100 4

Usage: python -m handyrl_tpu_torch.scripts.make_onnx_model
       [model.ckpt] [out.onnx] [--device DEV]
Reads the env from ./config.yaml.
"""

import os
import sys

import yaml

from ..device import pop_device_arg, resolve_device


def main(argv=None):
    device, argv = pop_device_arg(
        list(sys.argv[1:] if argv is None else argv))
    resolve_device(device)  # fail before any work when the card is absent
    ckpt = argv[0] if len(argv) > 0 else "models/latest.ckpt"
    out = argv[1] if len(argv) > 1 else (
        os.path.splitext(ckpt)[0] + ".onnx")

    with open("config.yaml") as f:
        env_args = yaml.safe_load(f)["env_args"]

    from ..environment import make_env
    from ..evaluation import load_model
    from ..interop.onnx_export import export_onnx

    env = make_env(env_args)
    env.reset()
    model = load_model(ckpt, env, device=device)
    obs = env.observation(env.players()[0])
    export_onnx(model, obs, out)
    size = os.path.getsize(out)
    print(f"wrote {out} ({size / 1024:.0f} KiB) from the model on "
          f"{model.device}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
