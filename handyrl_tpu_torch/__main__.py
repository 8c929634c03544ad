"""CLI entry point of the port: ``python -m handyrl_tpu_torch <mode>``.

Reads ``config.yaml`` from the working directory, as ``main.py`` does
for the JAX package.  Ported so far:

  --train / -t [--device DEV]
      local training: the learner, its worker fleet and the batched
      inference service on one machine; the replay ring, the net and
      Adam on DEV.  Checkpoints land in ``models/`` in the JAX
      package's format.
  --eval / -e [model_path] [num_games] [num_process] [--device DEV]
      offline evaluation of a saved model (``.ckpt`` or ``.npz`` of the
      JAX package's format) against the configured opponent.

``--device`` defaults to ``cuda``; a missing card is an error, not a
silent CPU run.  The other modes of ``main.py`` (``--train-server``,
``--worker``, ``--eval-server``, ``--eval-client``) are not ported yet
and exit non-zero.
"""

import sys

import yaml

from .device import DEFAULT_DEVICE, resolve_device

NOT_PORTED = ("--train-server", "-ts", "--worker", "-w",
              "--eval-server", "-es", "--eval-client", "-ec")


def _pop_device(argv):
    """Split ``--device DEV`` / ``--device=DEV`` out of ``argv``."""
    device, rest = DEFAULT_DEVICE, []
    it = iter(argv)
    for arg in it:
        if arg == "--device":
            device = next(it, None)
            if device is None:
                raise SystemExit("--device needs a value (cuda or cpu)")
        elif arg.startswith("--device="):
            device = arg.split("=", 1)[1]
        else:
            rest.append(arg)
    return device, rest


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv:
        print("Please set a mode (--train or --eval).")
        return 1
    mode, rest = argv[0], argv[1:]
    if mode in NOT_PORTED:
        print(f"mode {mode} is not ported to handyrl_tpu_torch yet; "
              f"use main.py for the JAX package")
        return 2
    if mode not in ("--eval", "-e", "--train", "-t"):
        print(f"Unknown mode {mode}.")
        return 1
    device, rest = _pop_device(rest)
    resolve_device(device)  # fail before any work when the card is absent
    with open("config.yaml") as f:
        args = yaml.safe_load(f)
    print(args)

    if mode in ("--train", "-t"):
        from .learner import train_main

        train_main(args, device=device)
        return 0

    from .evaluation import eval_main

    eval_main(args, rest, device=device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
