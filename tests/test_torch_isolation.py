"""The port stands alone: no JAX, no Flax, nothing of ``handyrl_tpu``.

A fresh interpreter imports the port, serves one batch on the CPU
through the inference service, plays one ``--eval`` game through the
CLI, imports every module of the training slice and trains three
steps from the replay ring, replays an episode WAL into the ring
(the resilience slice), and exports the model to ONNX, runs the file
and averages two checkpoints with the tools (the interop slice), and
runs a Trainer's fused Anakin step (the Anakin slice), serves a
batch over TCP through the serving frontend (the serving slice), and
counts a sync under the host-transfer guard and injects an shm fault
(the guards-and-chaos slice), and builds a sharded step over a
one-rank gloo group (the parallel slice);
afterwards no ``jax*``/``flax*``/``optax*`` or ``handyrl_tpu.*``
module may be loaded.  An AST scan of the package, its ``interop/``,
``scripts/``, ``anakin/``, ``telemetry/``, ``serving/``,
``analysis/``, ``parallel/`` and ``utils/`` subpackages included, finds no such
import anywhere, lazy ones included; importing ``chip_smoke`` loads
none either.  And the card is never replaced by the CPU behind the
caller's back.
"""

import ast
import os
import subprocess
import sys
import textwrap

import pytest
import torch

from handyrl_tpu_torch.__main__ import main as cli_main
from handyrl_tpu_torch.device import resolve_device
from torchfix import CHILD_ENV, one_torch_thread  # noqa: F401  (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PACKAGE = os.path.join(REPO, "handyrl_tpu_torch")
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "handyrl_tpu")

CHILD = textwrap.dedent("""
    import os, sys, time
    import numpy as np

    from handyrl_tpu_torch.__main__ import main
    from handyrl_tpu_torch.durability import write_checksummed
    from handyrl_tpu_torch.environment import make_env
    from handyrl_tpu_torch.models import TorchModel
    from handyrl_tpu_torch.models.convert import random_flax_params
    from handyrl_tpu_torch.models.geese_net import GeeseNet
    from handyrl_tpu_torch.pipeline import (
        InferenceService, PipelineClient, PipelineConfig, build_obs_spec)

    env = make_env({"env": "HungryGeese"})
    model = TorchModel(GeeseNet(filters=8, blocks=2), device="cpu")
    model.init_params(seed=0)
    cfg = PipelineConfig.from_config({"batch_window": 0.0})
    svc = InferenceService(model, cfg, epoch=1, device="cpu")
    svc.start()
    client = PipelineClient(svc.attach(build_obs_spec(env, 4)), cfg)
    try:
        deadline = time.monotonic() + 20
        while not client.healthy() or svc.warm_pending:
            assert time.monotonic() < deadline
            time.sleep(0.01)
        batch = np.stack([env.observation(p) for p in env.players()])
        out = client.wrap(model, 1).inference_batch(batch)
        assert out["policy"].shape == (4, 4)
        assert client.served_rows == 4 and client.local_rows == 0
    finally:
        svc.close()
        client.close()

    params = random_flax_params(GeeseNet(), seed=1)
    write_checksummed("m.ckpt", {"params": params, "epoch": 1})
    with open("config.yaml", "w") as f:
        f.write("env_args:\\n    env: HungryGeese\\n")
    assert main(["--eval", "m.ckpt", "1", "1", "--device", "cpu"]) == 0

    # the training slice: every module it added, and three ring steps
    import handyrl_tpu_torch.batch, handyrl_tpu_torch.config
    import handyrl_tpu_torch.connection, handyrl_tpu_torch.learner
    import handyrl_tpu_torch.ops.losses, handyrl_tpu_torch.ops.targets
    import handyrl_tpu_torch.ops.update, handyrl_tpu_torch.staging
    import handyrl_tpu_torch.worker
    from handyrl_tpu_torch.generation import Generator

    args = handyrl_tpu_torch.config.Config.from_dict(
        {"env_args": {"env": "HungryGeese"},
         "train_args": {"turn_based_training": False, "batch_size": 4,
                        "forward_steps": 4, "maximum_episodes": 8}}
    ).train_args.to_dict()
    gen = Generator(env, {"observation": False, "gamma": 0.8,
                          "compress_steps": 4})
    job = {"player": env.players(),
           "model_id": {p: 1 for p in env.players()}}
    trainer = handyrl_tpu_torch.learner.Trainer(args, model, device="cpu")
    episodes = [gen.generate({p: model for p in env.players()}, job)
                for _ in range(2)]
    trainer.device_replay.offer(episodes)
    trainer.device_replay.ingest()
    state = trainer.device_replay.device_state()
    metrics = [trainer._replay_step(state) for _ in range(3)]
    assert all(float(m["nonfinite"]) == 0 for m in metrics)

    # the resilience slice: the WAL replays into a ring, and every
    # module it added imports
    import handyrl_tpu_torch.resilience
    from handyrl_tpu_torch.durability import EpisodeWAL

    wal = EpisodeWAL("wal", flush_interval=0)
    for ep in episodes:
        wal.append(ep)
    wal.close()
    staged = trainer.device_replay.warm_start(
        [ep for _, ep in EpisodeWAL("wal").replay()])
    assert staged == 2

    # the interop slice: ONNX export and run, SWA, .npz, the league
    # learner and the network battle modules
    from handyrl_tpu_torch.interop import OnnxModel, export_onnx
    from handyrl_tpu_torch.scripts import aux_swa, export_model
    import handyrl_tpu_torch.scripts.make_onnx_model
    import handyrl_tpu_torch.evaluation

    export_onnx(model, env.observation(0), "m.onnx")
    assert OnnxModel("m.onnx").inference(env.observation(0))[
        "policy"].shape == (4,)
    os.makedirs("models")
    for epoch in (1, 2):
        write_checksummed(f"models/{epoch}.ckpt", {"params": params})
    assert aux_swa.main(["1", "2"]) == 0
    assert export_model.main(["models/swa.ckpt"]) == 0

    # the Anakin slice: the device env, the engine and the cost model;
    # two fused steps of a Trainer in Anakin mode
    import handyrl_tpu_torch.anakin, handyrl_tpu_torch.telemetry
    import handyrl_tpu_torch.envs.tictactoe_torch

    args = handyrl_tpu_torch.config.Config.from_dict(
        {"env_args": {"env": "TicTacToe"},
         "train_args": {"updates_per_epoch": 2,
                        "anakin": {"mode": "on", "num_envs": 8}}}
    ).train_args.to_dict()
    args["env"] = {"env": "TicTacToe"}
    ttt = TorchModel(make_env(args["env"]).net(), device="cpu")
    ttt.init_params(seed=0)
    trainer = handyrl_tpu_torch.learner.Trainer(args, ttt, device="cpu")
    trainer.update_flag = True
    trainer.train()
    assert trainer.last_metrics["anakin_games"] == 8

    # the serving slice: the serving tier and telemetry, one request
    # served over TCP from the CPU, and the run tools
    import handyrl_tpu_torch.serving.router
    import handyrl_tpu_torch.telemetry.status
    import handyrl_tpu_torch.utils.profiling
    from handyrl_tpu_torch.scripts import attribution_report, export_trace
    from handyrl_tpu_torch.serving import (
        ServeClient, ServingConfig, ServingFrontend)

    svc = InferenceService(model, cfg, epoch=1, device="cpu")
    svc.start()
    fe = ServingFrontend(svc, env, ServingConfig.from_config(
        {"mode": "on", "port": 0}))
    fe.start()
    client = ServeClient("127.0.0.1", fe.port, timeout=30)
    try:
        reply = client.infer_batch(batch)
        assert reply["epoch"] == 1
        assert reply["outputs"]["policy"].shape == (4, 4)
    finally:
        client.close()
        fe.close()
        svc.close()
    assert export_trace.main([]) == 1 and attribution_report

    # the guards-and-chaos slice: the runtime guards, the shm chaos
    # wrappers and the run tools
    import torch
    import handyrl_tpu_torch.scripts.perf_ledger
    import handyrl_tpu_torch.scripts.plot_metrics
    from handyrl_tpu_torch.analysis import HostTransferGuard, RetraceGuard
    from handyrl_tpu_torch.pipeline import ShmRing
    from handyrl_tpu_torch.resilience import ChaosConfig, ChaosRing

    with HostTransferGuard(is_device=lambda t: True) as guard:
        step = RetraceGuard(name="step").wrap(lambda x: x.sum().item())
        step(torch.ones(3))
    assert guard.transfers == 1
    ring = ShmRing.create(slots=2, slot_bytes=64)
    try:
        assert not ChaosRing(ring, ChaosConfig.from_config(
            {"shm_full_prob": 1.0})).push(b"x")
    finally:
        ring.close()

    # the parallel slice: a one-rank gloo group, its mesh and one
    # sharded step (every collective over one rank)
    from handyrl_tpu_torch.connection import find_free_port
    from handyrl_tpu_torch.ops.losses import LossConfig
    from handyrl_tpu_torch.parallel import (
        MeshSpec, make_mesh, make_sharded_update_step, multihost)

    assert multihost.init_distributed(
        {"coordinator_address": "127.0.0.1:%d" % find_free_port(),
         "num_processes": 1, "process_id": 0}, device="cpu")
    try:
        net = make_env(args["env"]).net()
        step = make_sharded_update_step(
            net, LossConfig.from_config(args), make_mesh(
                MeshSpec(dp=1, fsdp=True), device_type="cpu"), 1e-3)
        assert multihost.sync_epoch_code(multihost.EPOCH_END) == 1
    finally:
        multihost.shutdown()

    bad = sorted(m for m in sys.modules
                 if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax",
                                        "handyrl_tpu"))
    print("FORBIDDEN_MODULES", bad)
    assert not bad, bad
""")


def test_served_batch_and_eval_game_load_no_jax(tmp_path):
    env = dict(CHILD_ENV, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", CHILD], cwd=tmp_path,
                          env=env, capture_output=True, text=True,
                          timeout=240)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    assert "FORBIDDEN_MODULES []" in proc.stdout
    assert "agent 0: win rate" in proc.stdout


def _imports(path):
    tree = ast.parse(open(path).read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield node.lineno, alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.lineno, node.module or ""


def test_no_module_of_the_package_imports_jax_or_handyrl_tpu():
    sources = []
    for root, _dirs, files in os.walk(PACKAGE):
        sources += [os.path.join(root, f) for f in files
                    if f.endswith(".py")]
    assert len(sources) > 20
    walked = {os.path.relpath(os.path.dirname(path), PACKAGE)
              for path in sources}
    assert {"interop", "scripts", "models", "pipeline", "anakin",
            "telemetry", "serving", "utils", "analysis",
            "parallel"} <= walked
    bad = [f"{os.path.relpath(path, REPO)}:{line}: {name}"
           for path in sources for line, name in _imports(path)
           if name.split(".")[0] in FORBIDDEN]
    assert not bad, bad


def test_importing_chip_smoke_loads_no_jax():
    """The chip smoke test runs where no JAX is installed: importing it
    loads nothing of JAX or of the JAX package."""
    probe = ("import sys, chip_smoke; print('FORBIDDEN_MODULES', sorted("
             "m for m in sys.modules if m.split('.')[0] in %r))"
             % (FORBIDDEN,))
    proc = subprocess.run([sys.executable, "-c", probe], cwd=REPO,
                          env=dict(CHILD_ENV, PYTHONPATH=REPO),
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "FORBIDDEN_MODULES []" in proc.stdout


def test_asking_for_the_card_without_one_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; this checks its absence")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device("cuda")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli_main(["--eval", "none.ckpt", "1", "1"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli_main(["--train"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli_main(["--train-server"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli_main(["--eval-server", "1", "1"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli_main(["--eval-client", "none.ckpt", "localhost"])
    from handyrl_tpu_torch.envs import tictactoe_torch

    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tictactoe_torch.init(4)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tictactoe_torch.from_board([0] * 9)
    assert resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError, match="unsupported device"):
        resolve_device("mps")


def test_cli_refuses_modes_that_are_not_ported(capsys):
    """Since the network battle modes came over no mode of ``main.py``
    is refused as not ported: every one is accepted (it goes on to read
    its ``--device``), and only unknown modes exit 1."""
    modes = ("--train", "-t", "--train-server", "-ts", "--worker", "-w",
             "--eval", "-e", "--eval-server", "-es", "--eval-client",
             "-ec")
    for mode in modes:
        if mode in ("--worker", "-w"):
            # takes no --device: refused before any config is read
            assert cli_main([mode, "--device", "cpu"]) == 1
        else:
            with pytest.raises(ValueError, match="unsupported device"):
                cli_main([mode, "--device", "mps"])
    out = capsys.readouterr().out
    assert "not ported" not in out and "Unknown mode" not in out
    assert cli_main(["--bogus"]) == 1
    assert "Unknown mode --bogus" in capsys.readouterr().out
    assert cli_main([]) == 1


def test_worker_mode_takes_no_device(capsys):
    """``--worker`` starts only CPU processes: it refuses ``--device``
    before reading any config."""
    assert cli_main(["--worker", "2", "--device", "cuda"]) == 1
    assert cli_main(["-w", "--device=cpu"]) == 1
    assert "takes no --device" in capsys.readouterr().out
