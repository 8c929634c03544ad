"""CLI entry point of the port: ``python -m handyrl_tpu_torch <mode>``.

Reads ``config.yaml`` from the working directory, as ``main.py`` does
for the JAX package, with every mode of ``main.py``:

  --train / -t [--device DEV]
      local training: the learner, its supervised worker fleet and the
      batched inference service on one machine; the replay ring, the
      net and Adam on DEV.  Checkpoints land in ``models/`` in the JAX
      package's format, the episode WAL in ``models/wal/``.
  --train-server / -ts [--device DEV]
      a learner serving remote worker machines (entry port 9999,
      worker port 9998); the ring, the net and Adam on DEV, one rank
      per card of the host.  Remote workers keep local CPU inference.
  --worker / -w [num_parallel]
      this machine's gathers and workers join the learner at
      ``worker_args.server_address``; every process stays on the CPU
      and none initializes CUDA, so the mode takes no ``--device``.
      It serves learner sessions until it is stopped (SIGTERM).
  --eval / -e [model_path] [num_games] [num_process] [--device DEV]
      offline evaluation of a saved model (``.ckpt`` or ``.npz`` of the
      JAX package's format on DEV, or ``.onnx`` run by the numpy
      runner) against the configured opponent.
  --eval-server / -es [num_games] [num_process] [--device DEV]
      network battle server: hosts the env on port 9876 and plays
      ``num_games`` between remote clients; it runs no model.
  --eval-client / -ec [model_path] [host] [--device DEV]
      network battle client: takes seats at the server on ``host``,
      one spawned process per seat with the model on DEV.

Either training mode with no ``train_args.distributed`` on a host with
several visible cards spawns one rank per card (:mod:`.parallel.launch`:
JAX's auto-dp over a host's devices; one card runs one process, no
spawn); under ``--train-server`` rank 0 alone listens on the entry and
worker ports and deals every admitted episode to one rank's ring
(:mod:`.parallel.deal`).  ``train_args.supervise_learner: true`` runs
either training mode under a guard that relaunches it, the whole rank
group on a host with several cards, with ``restart_epoch: auto``; a
launch's exit code (a rank's, or the guard's) is this process's.
``train_args.distributed`` makes this process one rank of a
multi-process learner (start one per rank, each with its
``process_id``): the process group comes up before the card is touched
and comes down on every exit path (:mod:`.parallel`).
``--device`` defaults to ``cuda``; a missing card is an error, not a
silent CPU run.  The tools ``python -m handyrl_tpu_torch.scripts.<name>``
(``aux_swa``, ``export_model``, ``make_onnx_model``) sit beside the
modes.
"""

import sys

import yaml

from .device import pop_device_arg, resolve_device

MODES = ("--train", "-t", "--train-server", "-ts", "--worker", "-w",
         "--eval", "-e", "--eval-server", "-es", "--eval-client", "-ec")


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv:
        print("Please set a mode (--train, --train-server, --worker, "
              "--eval, --eval-server, --eval-client).")
        return 1
    mode, rest = argv[0], argv[1:]
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

    device, rest = pop_device_arg(rest)
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

    if mode in ("--eval-server", "-es"):
        from .evaluation import eval_server_main

        eval_server_main(args, rest)
        return 0
    if mode in ("--eval-client", "-ec"):
        from .evaluation import eval_client_main

        eval_client_main(args, rest, device=device)
        return 0

    from .evaluation import eval_main

    eval_main(args, rest, device=device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
