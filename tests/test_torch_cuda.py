"""The port on the card: tests that need a CUDA device.

They skip where ``torch.cuda.is_available()`` is False, deciding inside
a fixture (never at import, so every xdist worker collects the same
tests).  This file imports nothing of JAX, so it also runs where only
the port is installed; on the card:

    python -m pytest --noconftest tests/test_torch_cuda.py -q

Tolerance card vs CPU: cuDNN runs float32 convolutions in TF32 by
default (a 10-bit mantissa, about three decimal digits), so outputs
agree within 2e-3 times the largest output magnitude; same card, same
shapes agree within 1e-5.
"""

import time

import numpy as np
import pytest
import torch

from handyrl_tpu_torch.environment import make_env
from handyrl_tpu_torch.models import TorchModel
from handyrl_tpu_torch.models.convert import random_flax_params
from handyrl_tpu_torch.models.geese_net import GeeseNet
from handyrl_tpu_torch.pipeline import (
    InferenceService,
    PipelineClient,
    PipelineConfig,
    build_obs_spec,
)
from torchfix import one_torch_thread  # noqa: F401  (autouse)

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; torch.cuda.is_available() is "
                    "False here")
    return "cuda"


def _models(device, seed=0):
    params = random_flax_params(GeeseNet(), seed=seed)
    return (TorchModel.from_flax(GeeseNet(), params, device=device),
            TorchModel.from_flax(GeeseNet(), params, device="cpu"))


def _batch(n, seed=0):
    rng = np.random.default_rng(seed)
    env = make_env({"env": "HungryGeese"})
    obs = []
    while len(obs) < n:
        env.reset()
        for _ in range(int(rng.integers(0, 8))):
            env.step({p: int(rng.integers(4)) for p in env.turns()})
            if env.terminal():
                break
        obs.extend(env.observation(p) for p in env.players())
    return np.stack(obs[:n])


def test_card_forward_matches_cpu(cuda_device):
    card, cpu = _models(cuda_device)
    batch = _batch(64)
    ref = cpu.inference_batch(batch)
    out = card.inference_batch(batch)
    scale = max(1.0, max(float(np.abs(v).max()) for v in ref.values()))
    for key in ("policy", "value"):
        assert out[key].dtype == np.float32
        np.testing.assert_allclose(out[key], ref[key], rtol=0,
                                   atol=2e-3 * scale)


def test_card_service_answers_like_the_local_forward(cuda_device):
    card, _ = _models(cuda_device, seed=1)
    env = make_env({"env": "HungryGeese"})
    cfg = PipelineConfig.from_config({"batch_window": 0.0,
                                      "fallback": "none"})
    svc = InferenceService(card, cfg, epoch=1, device=cuda_device)
    svc.start()
    client = PipelineClient(svc.attach(build_obs_spec(env, 64)), cfg)
    try:
        deadline = time.monotonic() + 60
        while svc.warm_pending or not client.healthy():
            assert time.monotonic() < deadline
            time.sleep(0.01)
        batch = _batch(64, seed=2)
        served = client.wrap(card, 1).inference_batch(batch)
        local = card.inference_batch(batch)
        for key in ("policy", "value"):
            np.testing.assert_allclose(served[key], local[key], rtol=0,
                                       atol=1e-5)
        assert client.fallbacks == 0 and client.local_rows == 0
        assert svc.failure is None
    finally:
        svc.close()
        client.close()


RING = {"turn_based_training": False, "observation": False,
        "forward_steps": 8, "burn_in_steps": 0,
        "transfer_dtype": "bfloat16", "compute_dtype": "float32"}
LOSS = {"turn_based_training": False, "observation": False,
        "burn_in_steps": 0, "lambda": 0.7, "gamma": 0.8,
        "policy_target": "TD", "value_target": "TD",
        "entropy_regularization": 0.1,
        "entropy_regularization_decay": 0.1}


def test_card_ring_and_update_steps_match_cpu(cuda_device):
    """The replay ring gathers the same batch on the card as on the CPU
    (exactly), and two float32 update steps with TF32 off give the same
    losses (1e-4 relative) and parameters (0.05 x lr per step, where the
    gradient exceeds 1e-6)."""
    from handyrl_tpu_torch.ops.losses import LossConfig
    from handyrl_tpu_torch.ops.update import UpdateStep, make_optimizer
    from handyrl_tpu_torch.staging import DeviceReplay
    from torchfix import make_episodes

    episodes, _ = make_episodes("HungryGeese", 4, seed=3)
    rings = {}
    for dev in (cuda_device, "cpu"):
        rings[dev] = DeviceReplay(RING, 8, 1 << 30, dev)
        rings[dev].offer(episodes)
        rings[dev].ingest()
    rng = np.random.default_rng(0)
    idx = [torch.from_numpy(a) for a in (
        rng.integers(0, 4, 16), rng.integers(0, 20, 16),
        rng.integers(0, 4, 16))]
    batches = {dev: rings[dev].gather(*[a.to(dev) for a in idx])
               for dev in rings}
    for key, value in batches[cuda_device].items():
        assert torch.equal(value.cpu(), batches["cpu"][key]), key

    lr = 1e-3
    prev = (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        params = random_flax_params(GeeseNet(), seed=4)
        steps = {}
        for dev in rings:
            net = TorchModel.from_flax(GeeseNet(), params, device=dev).module
            steps[dev] = UpdateStep(net, LossConfig.from_config(LOSS),
                                    make_optimizer(net.parameters(), lr))
        for _ in range(2):
            before = {d: [p.detach().cpu().clone()
                          for p in steps[d].module.parameters()]
                      for d in steps}
            metrics = {d: steps[d](batches[d]) for d in steps}
            for key in ("p", "v", "ent", "total"):
                ref = float(metrics["cpu"][key])
                assert abs(float(metrics[cuda_device][key]) - ref) \
                    <= 1e-4 * max(abs(ref), 1.0), key
            for pc, ph, bc, bh in zip(steps[cuda_device].module.parameters(),
                                      steps["cpu"].module.parameters(),
                                      before[cuda_device], before["cpu"]):
                moved = ph.grad.abs() > 1e-6
                err = ((pc.detach().cpu() - bc) - (ph.detach() - bh)).abs()
                if moved.any():
                    assert float(err[moved].max()) <= 0.05 * lr
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = prev


def test_fused_replay_step_never_syncs_the_host(cuda_device):
    """Steady-state fused steps (device draw, gather, bf16 update) make
    no synchronizing CUDA call — no ``.item()``, no device-to-host read,
    no blocking upload: torch's sync debug mode raises on one."""
    from handyrl_tpu_torch.ops.losses import LossConfig
    from handyrl_tpu_torch.ops.update import UpdateStep, make_optimizer
    from handyrl_tpu_torch.staging import (
        DeviceReplay,
        make_replay_update_step,
    )
    from torchfix import make_episodes

    episodes, _ = make_episodes("HungryGeese", 4, seed=5)
    ring = DeviceReplay(dict(RING, compute_dtype="bfloat16"), 8, 1 << 30,
                        cuda_device)
    ring.offer(episodes)
    ring.ingest()
    net = TorchModel.from_flax(GeeseNet(), random_flax_params(GeeseNet()),
                               device=cuda_device).module
    update = UpdateStep(net, LossConfig.from_config(LOSS),
                        make_optimizer(net.parameters(), 1e-4), "bfloat16")
    step = make_replay_update_step(ring, update, batch_size=16, seed=0)
    state = ring.device_state()
    step(state)  # first call: library setup may synchronize
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        metrics = [step(state) for _ in range(3)]
        with pytest.raises(RuntimeError):  # the mode is armed: a read
            float(metrics[-1]["total"])    # back to the host raises
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert all(float(m["nonfinite"]) == 0 for m in metrics)


def test_card_warm_start_and_emergency_save(cuda_device, tmp_path,
                                            monkeypatch):
    """``warm_start`` (the WAL replay) fills the ring on the card bit for
    bit as on the CPU; and an emergency save, armed from another thread
    the way the SIGTERM handler arms it, lands the parameters and Adam
    state of exactly the step it reports, bit for bit."""
    import threading

    from handyrl_tpu_torch.config import Config
    from handyrl_tpu_torch.durability import read_verified
    from handyrl_tpu_torch.learner import Trainer
    from handyrl_tpu_torch.models.convert import to_flax
    from handyrl_tpu_torch.staging import DeviceReplay
    from handyrl_tpu_torch.utils.tree import tree_leaves
    from torchfix import make_episodes

    episodes, _ = make_episodes("HungryGeese", 5, seed=7)
    rings = {dev: DeviceReplay(RING, 8, 1 << 30, dev)
             for dev in (cuda_device, "cpu")}
    for ring in rings.values():
        assert ring.warm_start(episodes, chunk=2) == 5
    for a, b in zip(tree_leaves(rings[cuda_device].buffers),
                    tree_leaves(rings["cpu"].buffers)):
        assert torch.equal(a.cpu(), b)

    monkeypatch.chdir(tmp_path)
    args = Config.from_dict(
        {"env_args": {"env": "HungryGeese"},
         "train_args": {"turn_based_training": False, "batch_size": 16,
                        "forward_steps": 8, "maximum_episodes": 8,
                        "compute_dtype": "bfloat16"}}).train_args.to_dict()
    model = TorchModel(GeeseNet(), device="cpu")
    model.init_params(seed=0)
    trainer = Trainer(args, model, device=cuda_device)
    trainer.device_replay.warm_start(episodes)
    trainer.epoch = 1
    state = trainer.device_replay.device_state()
    after = {}   # step count -> host params after that step

    def trainer_thread():
        while trainer.steps < 40:
            trainer._maybe_emergency_save()
            trainer._replay_step(state)
            trainer.steps += 1
            after[trainer.steps] = to_flax(trainer.module)

    thread = threading.Thread(target=trainer_thread)
    thread.start()
    while trainer.steps < 5:
        time.sleep(0.001)
    event = threading.Event()
    trainer.emergency = event
    assert event.wait(30)
    thread.join(60)
    saved = read_verified("models/latest.ckpt")
    steps = saved["steps"]
    assert 5 <= steps < 40 and saved["epoch"] == 1
    ref = tree_leaves(after[steps])
    got = tree_leaves(saved["params"])
    assert len(ref) == len(got)
    for a, b in zip(got, ref):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    train_state = read_verified("models/train_state.ckpt")
    assert train_state["steps"] == steps and train_state["epoch"] == 1


def _geister_obs(n, seed=0):
    rng = np.random.default_rng(seed)
    env = make_env({"env": "Geister"})
    obs = []
    while len(obs) < n:
        env.reset()
        for _ in range(int(rng.integers(0, 30))):
            if env.terminal():
                break
            env.step({p: env.legal_actions(p)[int(rng.integers(
                len(env.legal_actions(p))))] for p in env.turns()})
        obs.extend(env.observation(p) for p in env.players())
    return {k: np.stack([o[k] for o in obs[:n]]) for k in obs[0]}


def test_card_recurrent_forward_matches_cpu(cuda_device):
    """GeisterNet (32 filters, DRC 3 x 3) and GRFNet at the (72, 96, 16)
    raster, from a non-zero hidden state, TF32 off: every head and every
    new hidden leaf agree within 1e-4 of the output's magnitude."""
    from handyrl_tpu_torch.models.geister_net import GeisterNet
    from handyrl_tpu_torch.models.grf_net import GRFNet

    rng = np.random.default_rng(1)
    cases = [(GeisterNet(), _geister_obs(32)),
             (GRFNet(), (rng.random((8, 72, 96, 16)) > 0.9).astype(
                 np.float32))]
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        for module, obs in cases:
            params = random_flax_params(module, seed=2)
            card = TorchModel.from_flax(module, params, device=cuda_device)
            cpu = TorchModel.from_flax(type(module)(), params, device="cpu")
            n = len(next(iter(obs.values()))) if isinstance(obs, dict) \
                else len(obs)
            hidden = {k: (0.5 * rng.standard_normal(v.shape)).astype(
                np.float32) for k, v in cpu.init_hidden([n]).items()}
            ref = cpu.inference_batch(obs, hidden)
            out = card.inference_batch(obs, hidden)
            for key in ref:
                pairs = (ref[key].items() if key == "hidden"
                         else [(key, ref[key])])
                got = out[key]
                for name, value in pairs:
                    have = got[name] if key == "hidden" else got
                    assert have.dtype == np.float32
                    scale = max(1.0, float(np.abs(value).max()))
                    np.testing.assert_allclose(have, value, rtol=0,
                                               atol=1e-4 * scale,
                                               err_msg=name)
    finally:
        torch.backends.cudnn.allow_tf32 = prev


def test_card_recurrent_update_step_matches_cpu(cuda_device):
    """One float32 GeisterNet step (turn mode, burn-in 4) from the ring
    on the card and on the CPU, TF32 off: the ring gathers the same
    batch exactly, the losses agree within 1e-4 relative and every
    parameter moves the same within 0.05 x lr where the gradient
    exceeds 1e-6."""
    from handyrl_tpu_torch.models.geister_net import GeisterNet
    from handyrl_tpu_torch.ops.losses import LossConfig
    from handyrl_tpu_torch.ops.update import UpdateStep, make_optimizer
    from handyrl_tpu_torch.staging import DeviceReplay
    from torchfix import make_episodes

    narrow = {"filters": 8, "drc_layers": 2, "drc_repeats": 2}
    episodes, _ = make_episodes("Geister", 3, seed=3,
                                net=GeisterNet(**narrow))
    ring_cfg = {"turn_based_training": True, "observation": False,
                "forward_steps": 8, "burn_in_steps": 4,
                "transfer_dtype": "bfloat16", "compute_dtype": "float32"}
    loss = dict(LOSS, turn_based_training=True, burn_in_steps=4)
    rings = {}
    for dev in (cuda_device, "cpu"):
        rings[dev] = DeviceReplay(ring_cfg, 4, 1 << 30, dev)
        rings[dev].offer(episodes)
        rings[dev].ingest()
    rng = np.random.default_rng(0)
    idx = [torch.from_numpy(a) for a in (
        rng.integers(0, 3, 16), rng.integers(0, 20, 16),
        np.zeros(16, np.int64))]
    batches = {dev: rings[dev].gather(*[a.to(dev) for a in idx])
               for dev in rings}
    from handyrl_tpu_torch.utils.tree import tree_leaves
    for a, b in zip(tree_leaves(batches[cuda_device]),
                    tree_leaves(batches["cpu"])):
        assert torch.equal(a.cpu(), b)

    lr = 1e-3
    prev = (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        params = random_flax_params(GeisterNet(**narrow), seed=4)
        steps = {}
        for dev in rings:
            net = TorchModel.from_flax(GeisterNet(**narrow), params,
                                       device=dev).module
            steps[dev] = UpdateStep(net, LossConfig.from_config(loss),
                                    make_optimizer(net.parameters(), lr))
        before = {d: [p.detach().cpu().clone()
                      for p in steps[d].module.parameters()] for d in steps}
        metrics = {d: steps[d](batches[d]) for d in steps}
        for key in ("p", "v", "r", "ent", "total"):
            ref = float(metrics["cpu"][key])
            assert abs(float(metrics[cuda_device][key]) - ref) \
                <= 1e-4 * max(abs(ref), 1.0), key
        for pc, ph, bc, bh in zip(steps[cuda_device].module.parameters(),
                                  steps["cpu"].module.parameters(),
                                  before[cuda_device], before["cpu"]):
            moved = ph.grad.abs() > 1e-6
            err = ((pc.detach().cpu() - bc) - (ph.detach() - bh)).abs()
            if moved.any():
                assert float(err[moved].max()) <= 0.05 * lr
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = prev


def test_card_forward_matches_the_onnx_runner(cuda_device, tmp_path):
    """GeeseNet 32x12 exported from the card: the numpy runner's outputs
    against the card's float32 forward with TF32 and cuDNN off (the
    pinned set of chip_smoke.py): within 1e-4 of the output's largest
    magnitude."""
    from handyrl_tpu_torch.interop import OnnxModel, export_onnx

    card, _ = _models(cuda_device, seed=3)
    batch = _batch(8, seed=3)
    path = str(tmp_path / "geese.onnx")
    export_onnx(card, batch[0], path)
    runner = OnnxModel(path)
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        with torch.backends.cudnn.flags(enabled=False, allow_tf32=False):
            ref = card.inference_batch(batch)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    for i, obs in enumerate(batch):
        out = runner.inference(obs)
        for key in ("policy", "value"):
            scale = float(np.abs(ref[key][i]).max())
            assert np.abs(out[key] - ref[key][i]).max() <= 1e-4 * scale


def test_card_and_cpu_exports_are_byte_identical(cuda_device, tmp_path):
    """The same checkpoint exported from the card and from the CPU
    gives the same file, byte for byte: the graph and the float32
    initializers do not depend on the device the trace ran on."""
    from handyrl_tpu_torch.interop import export_onnx
    from handyrl_tpu_torch.models.geister_net import GeisterNet

    blobs = {}
    for net, env_name in ((GeeseNet(), "HungryGeese"),
                          (GeisterNet(), "Geister")):
        env = make_env({"env": env_name})
        env.reset()
        obs = env.observation(env.players()[0])
        params = random_flax_params(net, seed=5)
        for device in (cuda_device, "cpu"):
            model = TorchModel.from_flax(type(net)(), params, device=device)
            path = str(tmp_path / f"{env_name}_{device}.onnx")
            export_onnx(model, obs, path)
            with open(path, "rb") as f:
                blobs[env_name, device] = f.read()
        assert blobs[env_name, cuda_device] == blobs[env_name, "cpu"]


def _ttt_engine(device, num_envs, opponent_pool=0):
    from handyrl_tpu_torch.anakin import AnakinConfig, AnakinEngine
    from handyrl_tpu_torch.envs import tictactoe_torch
    from handyrl_tpu_torch.models.tictactoe_net import TicTacToeNet
    from handyrl_tpu_torch.ops.losses import LossConfig
    from handyrl_tpu_torch.ops.update import UpdateStep, make_optimizer

    net = TicTacToeNet()
    net.load_state_dict(TorchModel.from_flax(
        TicTacToeNet(), random_flax_params(TicTacToeNet(), seed=2),
        device="cpu").module.state_dict())
    net = net.to(device)
    cfg = LossConfig.from_config({
        "turn_based_training": True, "observation": False,
        "burn_in_steps": 0, "lambda": 0.7, "gamma": 0.8,
        "policy_target": "TD", "value_target": "TD",
        "entropy_regularization": 0.1,
        "entropy_regularization_decay": 0.1})
    step = UpdateStep(net, cfg, make_optimizer(net.parameters(), 1e-3),
                      "bfloat16")
    return AnakinEngine(tictactoe_torch, step, AnakinConfig.from_config(
        {"mode": "on", "num_envs": num_envs,
         "opponent_pool": opponent_pool}), compute_dtype="bfloat16")


def test_device_env_steps_like_the_cpu_env(cuda_device):
    """Random legal play of 4,096 games on the card and on the CPU from
    the same actions: every state and step output equal."""
    from handyrl_tpu_torch.envs import tictactoe_torch as env

    rng = np.random.default_rng(0)
    states = {d: env.init(4096, d) for d in (cuda_device, "cpu")}
    for _ in range(env.MAX_STEPS):
        legal = env.legal_mask(states["cpu"]).numpy()
        scores = rng.random(legal.shape) * legal
        action = torch.from_numpy(scores.argmax(axis=1))
        outs = {d: env.step(states[d], action.to(d)) for d in states}
        for a, b in zip(outs[cuda_device][1:], outs["cpu"][1:]):
            assert torch.equal(a.cpu(), b)
        states = {d: out[0] for d, out in outs.items()}
        assert all(torch.equal(a.cpu(), b) for a, b in zip(
            states[cuda_device], states["cpu"]))


def test_rollout_runs_without_a_host_sync(cuda_device):
    """A whole rollout segment (1,024 games, one frozen opponent) under
    ``set_sync_debug_mode("error")``: any host synchronisation raises."""
    engine = _ttt_engine(cuda_device, 1024, opponent_pool=1)
    pool = engine.init_pool(engine.update_step.module)
    carry = engine.init_carry(0)
    with torch.no_grad():
        engine.rollout(engine.update_step.module, pool, carry)  # warm-up
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            batch, carry, frames = engine.rollout(
                engine.update_step.module, pool, carry)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    assert 5 * 1024 <= int(frames) <= 9 * 1024
    assert batch["observation"].device.type == "cuda"


def test_host_transfer_guard_counts_card_syncs(cuda_device):
    """The default predicate on the card: every Python-visible sync of a
    CUDA tensor counts, host tensors and device-to-device moves do not,
    and the counts agree with ``set_sync_debug_mode("warn")`` on these
    method calls."""
    import warnings

    from handyrl_tpu_torch.analysis import HostTransferGuard

    x = torch.arange(4.0, device=cuda_device)
    host = torch.arange(4.0)
    with HostTransferGuard() as guard:
        x.sum().item()
        x.tolist()
        x.cpu()
        x.to("cpu")
        float(x[0])
        bool(x[1] > 0)
        x.to(cuda_device)            # device to device: no transfer
        x.to(torch.float16)          # a cast on the card: no transfer
        host.tolist()                # a host tensor: free
        float(host[0])
    assert guard.transfers == 6
    with warnings.catch_warnings(record=True) as caught, \
            HostTransferGuard() as guard:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            x.sum().item()
            x.cpu()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    assert guard.transfers == 2 and len(caught) >= 2
