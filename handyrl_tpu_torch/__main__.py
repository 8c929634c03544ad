"""CLI entry point of the port: ``python -m handyrl_tpu_torch <mode>``.

Reads ``config.yaml`` from the working directory, as ``main.py`` does
for the JAX package.  Ported so far:

  --train / -t [--device DEV]
      local training: the learner, its supervised worker fleet and the
      batched inference service on one machine; the replay ring, the
      net and Adam on DEV.  Checkpoints land in ``models/`` in the JAX
      package's format, the episode WAL in ``models/wal/``.
  --train-server / -ts [--device DEV]
      a learner serving remote worker machines (entry port 9999,
      worker port 9998); the ring, the net and Adam on DEV.  Remote
      workers keep local CPU inference.
  --worker / -w [num_parallel]
      this machine's gathers and workers join the learner at
      ``worker_args.server_address``; every process stays on the CPU
      and none initializes CUDA, so the mode takes no ``--device``.
      It serves learner sessions until it is stopped (SIGTERM).
  --eval / -e [model_path] [num_games] [num_process] [--device DEV]
      offline evaluation of a saved model (``.ckpt`` or ``.npz`` of the
      JAX package's format) against the configured opponent.

``train_args.supervise_learner: true`` runs either training mode's
learner under a guard that relaunches it with ``restart_epoch: auto``.
``--device`` defaults to ``cuda``; a missing card is an error, not a
silent CPU run.  The network-battle modes of ``main.py``
(``--eval-server``, ``--eval-client``) are not ported yet and exit 2.
"""

import sys

import yaml

from .device import DEFAULT_DEVICE, resolve_device

NOT_PORTED = ("--eval-server", "-es", "--eval-client", "-ec")
MODES = ("--train", "-t", "--train-server", "-ts", "--worker", "-w",
         "--eval", "-e")


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
        print("Please set a mode (--train, --train-server, --worker or "
              "--eval).")
        return 1
    mode, rest = argv[0], argv[1:]
    if mode in NOT_PORTED:
        print(f"mode {mode} is not ported to handyrl_tpu_torch yet; "
              f"use main.py for the JAX package")
        return 2
    if mode not in MODES:
        print(f"Unknown mode {mode}.")
        return 1
    if mode in ("--worker", "-w"):
        if any(a == "--device" or a.startswith("--device=") for a in rest):
            print("--worker runs only CPU processes and takes no --device")
            return 1
        with open("config.yaml") as f:
            args = yaml.safe_load(f)
        print(args)
        from .worker import worker_main

        worker_main(args, rest)
        return 0

    device, rest = _pop_device(rest)
    resolve_device(device)  # fail before any work when the card is absent
    with open("config.yaml") as f:
        args = yaml.safe_load(f)
    print(args)

    if mode in ("--train", "-t"):
        from .learner import train_main

        train_main(args, device=device)
        return 0
    if mode in ("--train-server", "-ts"):
        from .learner import train_server_main

        train_server_main(args, device=device)
        return 0

    from .evaluation import eval_main

    eval_main(args, rest, device=device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
