"""Anakin over dp ranks: the env axis sharded over the ranks of one host.

One spawn of two gloo ranks on the CPU:

  * each rank's engine plays its half of ``num_envs`` (24 games, an
    opponent pool of 2, so rank 0 holds group 0 and half of group 1,
    rank 1 the other half and group 2): every rollout row equals the
    one-rank rollout's row at N games (the forward's probabilities and
    values within 1e-6, every other key exactly), and after two fused
    steps the parameters are the one-rank engine's at JAX's tolerance (params
    rtol 2e-4 / atol 2e-5; the sharded step sums the two halves'
    gradients);
  * the JAX engine on a dp-2 virtual CPU mesh (its env axis sharded
    over ``dp``, ``handyrl_tpu/anakin/rollout.py``) plays two fused
    steps; the two ranks replay its draws through ``actions`` and
    end on its parameters at the same tolerance, its ``total`` within
    rel 1e-4 and its frame count exactly (jax.random and torch streams
    cannot be matched, so the draws are injected);
  * a ``Trainer`` with ``anakin: {mode: on}`` on the two ranks builds
    the dp-2 mesh, plays its rows and reports the games of both ranks
    in its epoch record;
  * when the ranks report different host names the learner keeps the
    JAX package's multi-host fallback: ``auto`` warns and trains from
    the ring, ``on`` raises, with JAX's message.
"""

import os
import pickle
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from handyrl_tpu_torch.anakin import AnakinConfig, AnakinEngine
from handyrl_tpu_torch.connection import find_free_port
from handyrl_tpu_torch.envs import tictactoe_torch as tttt
from handyrl_tpu_torch.models.convert import (
    from_flax,
    random_flax_params,
    state_to_flax,
)
from handyrl_tpu_torch.ops.losses import LossConfig
from handyrl_tpu_torch.ops.update import UpdateStep, make_optimizer
from handyrl_tpu_torch.utils.tree import flatten_params
from torchfix import CHILD_ENV, loss_cfg, one_torch_thread  # noqa: F401
from torchfix import twin_nets

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# LR as in test_torch_parallel.py: Adam moves an element whose gradient
# sits at float32 rounding level by up to ~lr either way
NUM_ENVS, POOL, SEED, LR = 24, 2, 3, 1e-4
# the JAX engine's pool on its dp-2 mesh: at K = 2 there XLA's CPU
# backend mispartitions the pool's grouped convolution (the rollout
# alone does not compile, the fused step returns another loss than the
# unsharded engine's), so the JAX check plays K = 3: the self-play group
# and one slot on rank 0, two slots on rank 1
JAX_POOL = 3
PARAM_RTOL, PARAM_ATOL = 2e-4, 2e-5
# the keys the forward's floats make: the CPU's GEMM rounds a 12-row
# batch and a 24-row one differently in the last bits (measured 6e-8);
# the sampled actions, which decide every other key, agree exactly
FORWARD_KEYS, FORWARD_ATOL = ("selected_prob", "value"), 1e-6
FALLBACK = ("anakin mode is single-process (multi-host learners keep the "
            "IMPALA path)")

CHILD = textwrap.dedent("""
    import contextlib, io, pickle, socket, sys
    import torch

    rank, port, port2, run = sys.argv[1:5]
    rank = int(rank)
    torch.set_num_threads(1)
    with open(run + "/in.pkl", "rb") as f:
        job = pickle.load(f)
    from handyrl_tpu_torch.anakin import AnakinConfig, AnakinEngine
    from handyrl_tpu_torch.config import Config
    from handyrl_tpu_torch.envs import tictactoe_torch as tttt
    from handyrl_tpu_torch.environment import make_env
    from handyrl_tpu_torch.learner import Trainer
    from handyrl_tpu_torch.models import TorchModel
    from handyrl_tpu_torch.models.convert import from_flax
    from handyrl_tpu_torch.ops.losses import LossConfig
    from handyrl_tpu_torch.parallel import multihost as mh
    from handyrl_tpu_torch.parallel import (
        MeshSpec, make_mesh, make_sharded_update_step)
    from handyrl_tpu_torch.parallel.update import full_state_dict

    def group(p):
        mh.init_distributed({"coordinator_address": "127.0.0.1:" + p,
                             "num_processes": 2, "process_id": rank},
                            device="cpu")

    def net():
        module = make_env({"env": "TicTacToe"}).net()
        module.load_state_dict(from_flax(job["params"], module))
        return module

    def trainer_args(mode):
        args = Config.from_dict({
            "env_args": {"env": "TicTacToe"},
            "train_args": {"batch_size": 16, "minimum_episodes": 4,
                           "maximum_episodes": 64, "updates_per_epoch": 4,
                           "compute_dtype": "float32",
                           "anakin": {"mode": mode,
                                      "num_envs": job["num_envs"]}}},
        ).train_args.to_dict()
        args["env"] = {"env": "TicTacToe"}
        return args

    def model():
        return TorchModel(net(), device="cpu")

    rec = {}
    group(port)
    rec["one_host"] = mh.one_host()
    module = net()
    step = make_sharded_update_step(
        module, LossConfig.from_config(job["cfg"]),
        make_mesh(MeshSpec(dp=2), device_type="cpu"), job["lr"], "float32")
    share = job["num_envs"] // 2
    engine = AnakinEngine(tttt, step, AnakinConfig.from_config(
        {"mode": "on", "num_envs": job["num_envs"],
         "opponent_pool": job["pool"]}), seed=job["seed"],
        rows=(rank * share, (rank + 1) * share))
    pool = engine.init_pool(module)
    with torch.no_grad():
        batch, _, frames = engine.rollout(module, pool,
                                          engine.init_carry(0))
    rec["rollout"] = {k: v.numpy() for k, v in batch.items()}
    rec["frames"] = float(frames)
    fused, carry = engine.make_fused_step(), engine.init_carry(0)
    for _ in range(2):
        metrics, carry = fused(carry, pool)
    rec["totals"] = float(metrics["total"])
    rec["params"] = {k: v.numpy() for k, v in
                     full_state_dict(module).items()}
    # the JAX engine's draws on its dp-2 mesh, replayed from its weights
    module = net()
    step = make_sharded_update_step(
        module, LossConfig.from_config(job["cfg"]),
        make_mesh(MeshSpec(dp=2), device_type="cpu"), job["lr"], "float32")
    engine = AnakinEngine(tttt, step, AnakinConfig.from_config(
        {"mode": "on", "num_envs": job["num_envs"],
         "opponent_pool": job["jax_pool"]}), seed=job["seed"],
        rows=(rank * share, (rank + 1) * share))
    pool = engine.init_pool(module)
    fused, carry = engine.make_fused_step(), engine.init_carry(0)
    rec["jax_frames"] = []
    for actions in job["jax_actions"]:
        metrics, carry = fused(carry, pool, torch.from_numpy(actions))
        rec["jax_frames"].append(float(metrics["anakin_frames"]))
    rec["jax_total"] = float(metrics["total"])
    rec["jax_params"] = {k: v.numpy() for k, v in
                         full_state_dict(module).items()}
    # a Trainer in anakin mode on the rank mesh: one fused step, one epoch
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        trainer = Trainer(trainer_args("on"), model(), device="cpu")
        trainer.update_flag = True
        trainer.train()
    rec["trainer_rows"] = trainer.anakin.rows
    rec["trainer_record"] = dict(trainer.last_metrics)
    rec["trainer_out"] = out.getvalue()
    mh.shutdown()

    # the same ranks reporting two hosts
    socket.gethostname = lambda: "host%d" % rank
    group(port2)
    rec["two_hosts_one_host"] = mh.one_host()
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        trainer = Trainer(trainer_args("auto"), model(), device="cpu")
    rec["auto_anakin"] = trainer.anakin is not None
    rec["auto_ring"] = trainer.device_replay is not None
    rec["auto_out"] = out.getvalue()
    try:
        Trainer(trainer_args("on"), model(), device="cpu")
        rec["on_error"] = None
    except ValueError as exc:
        rec["on_error"] = str(exc)
    mh.shutdown()
    with open(run + "/out%d.pkl" % rank, "wb") as f:
        pickle.dump(rec, f)
    print("CHILD %d DONE" % rank)
""")


def _params():
    return random_flax_params(tttt_net(), seed=SEED)


def tttt_net():
    from handyrl_tpu_torch.environment import make_env

    return make_env({"env": "TicTacToe"}).net()


def _jax_on_a_dp2_mesh(params, cfg):
    """The JAX engine sharding its env axis over a dp-2 mesh of virtual
    CPU devices: two fused steps from ``params``.  Returns each
    segment's draws as the (T, N) actions seam, each step's frames, the
    last ``total`` and the parameters after."""
    import jax
    import jax.numpy as jnp

    from handyrl_tpu.anakin import AnakinConfig as JaxAnakinConfig
    from handyrl_tpu.anakin import AnakinEngine as JaxAnakinEngine
    from handyrl_tpu.environment import make_jax_env
    from handyrl_tpu.models import TPUModel
    from handyrl_tpu.ops import update as jupdate
    from handyrl_tpu.ops.losses import LossConfig as JaxLossConfig
    from handyrl_tpu.parallel.mesh import MeshSpec as JaxMeshSpec
    from handyrl_tpu.parallel.mesh import make_mesh as jax_make_mesh

    flax_net = twin_nets("TicTacToe")[0]
    params = jax.tree.map(jnp.asarray, params)
    opt = jupdate.make_optimizer(LR)
    mesh = jax_make_mesh(JaxMeshSpec(dp=2), devices=jax.devices()[:2])
    engine = JaxAnakinEngine(
        make_jax_env({"env": "TicTacToe"}), TPUModel(flax_net, params),
        JaxLossConfig.from_config(cfg), opt,
        JaxAnakinConfig.from_config({"mode": "on", "num_envs": NUM_ENVS,
                                     "opponent_pool": JAX_POOL}),
        seed=SEED, mesh=mesh, params=params)
    pool, carry = engine.init_pool(params), engine.init_carry(0)
    opt_state = opt.init(params)
    rollout, fused = jax.jit(engine._rollout), engine.make_fused_step()
    actions, frames = [], []
    for _ in range(2):
        # the segment's draws: the fused step's own rollout on the same
        # params, pool and carry
        batch, _, _ = rollout(params, pool, carry)
        actions.append(np.ascontiguousarray(
            np.asarray(batch["action"])[:, :, 0, 0].T))
        params, opt_state, metrics, carry = fused(params, opt_state,
                                                  carry, pool)
        frames.append(float(metrics["anakin_frames"]))
    return (actions, frames, float(metrics["total"]),
            flatten_params(jax.device_get(params)))


@pytest.fixture(scope="module")
def jax_dp2():
    return _jax_on_a_dp2_mesh(_params(), loss_cfg())


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory, jax_dp2):
    """One spawn of two gloo ranks (a 150 s deadline)."""
    run = tmp_path_factory.mktemp("anakin_ranks")
    job = {"params": _params(), "num_envs": NUM_ENVS, "pool": POOL,
           "seed": SEED, "lr": LR, "cfg": loss_cfg(),
           "jax_actions": jax_dp2[0], "jax_pool": JAX_POOL}
    with open(run / "in.pkl", "wb") as f:
        pickle.dump(job, f)
    ports = [str(find_free_port()), str(find_free_port())]
    env = dict(CHILD_ENV, PYTHONPATH=REPO)
    procs = [subprocess.Popen(
        [sys.executable, "-c", CHILD, str(rank), *ports, str(run)],
        cwd=run, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for rank in range(2)]
    outs = []
    try:
        for proc in procs:
            outs.append(proc.communicate(timeout=150)[0])
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
    for rank, (proc, out) in enumerate(zip(procs, outs)):
        assert proc.returncode == 0 and f"CHILD {rank} DONE" in out, \
            out[-3000:]
    recs = []
    for rank in range(2):
        with open(run / f"out{rank}.pkl", "rb") as f:
            recs.append(pickle.load(f))
    return recs, job


def _one_rank(job):
    """The one-rank engine at all N games: its rollout, then two fused
    steps from a fresh carry."""
    net = tttt_net()
    net.load_state_dict(from_flax(job["params"], net))
    step = UpdateStep(net, LossConfig.from_config(job["cfg"]),
                      make_optimizer(net.parameters(), LR), "float32")
    engine = AnakinEngine(tttt, step, AnakinConfig.from_config(
        {"mode": "on", "num_envs": NUM_ENVS, "opponent_pool": POOL}),
        seed=SEED)
    pool = engine.init_pool(net)
    with torch.no_grad():
        batch, _, frames = engine.rollout(net, pool, engine.init_carry(0))
    fused, carry = engine.make_fused_step(), engine.init_carry(0)
    for _ in range(2):
        metrics, carry = fused(carry, pool)
    return ({k: v.numpy() for k, v in batch.items()}, float(frames),
            float(metrics["total"]),
            {k: v.numpy() for k, v in net.state_dict().items()})


def test_two_ranks_roll_out_the_one_rank_rows(two_ranks):
    recs, job = two_ranks
    batch, frames, _, _ = _one_rank(job)
    share = NUM_ENVS // 2
    for rank, rec in enumerate(recs):
        assert rec["one_host"]
        rows = slice(rank * share, (rank + 1) * share)
        assert set(rec["rollout"]) == set(batch)
        for key, value in batch.items():
            if key in FORWARD_KEYS:
                np.testing.assert_allclose(
                    rec["rollout"][key], value[rows], rtol=0,
                    atol=FORWARD_ATOL, err_msg=f"rank {rank} {key}")
            else:
                np.testing.assert_array_equal(
                    rec["rollout"][key], value[rows],
                    err_msg=f"rank {rank} {key}")
    assert recs[0]["frames"] + recs[1]["frames"] == frames


def test_two_ranks_fused_steps_match_one_rank(two_ranks):
    recs, job = two_ranks
    _, _, total, params = _one_rank(job)
    for rec in recs:
        assert rec["totals"] == pytest.approx(total, rel=1e-4)
        for name, value in params.items():
            np.testing.assert_allclose(rec["params"][name], value,
                                       rtol=PARAM_RTOL, atol=PARAM_ATOL,
                                       err_msg=name)


def test_two_ranks_replay_the_jax_dp2_mesh_to_its_params(two_ranks,
                                                         jax_dp2):
    """JAX's engine with the env axis on a dp-2 mesh against the two
    ranks with its draws: frames exact, ``total`` rel 1e-4, params at
    JAX's tolerance."""
    recs, _ = two_ranks
    _, frames, total, jparams = jax_dp2
    net = tttt_net()
    for rank, rec in enumerate(recs):
        assert rec["jax_total"] == pytest.approx(total, rel=1e-4)
        got = flatten_params(state_to_flax(
            {k: torch.from_numpy(v) for k, v in rec["jax_params"].items()},
            net))
        assert set(got) == set(jparams)
        for path, value in jparams.items():
            np.testing.assert_allclose(got[path], np.asarray(value),
                                       rtol=PARAM_RTOL, atol=PARAM_ATOL,
                                       err_msg=f"rank {rank} {path}")
    # each rank counts its rows' frames; the two sum to the mesh's
    per_step = np.add(recs[0]["jax_frames"], recs[1]["jax_frames"])
    np.testing.assert_array_equal(per_step, frames)


def test_trainer_runs_anakin_on_the_rank_mesh(two_ranks):
    recs, _ = two_ranks
    share = NUM_ENVS // 2
    for rank, rec in enumerate(recs):
        assert rec["trainer_rows"] == (rank * share, (rank + 1) * share)
        assert "mesh dp=2 sp=1 tp=1 over 2 processes" in rec["trainer_out"]
        assert (f"this rank plays games [{rank * share}, "
                f"{(rank + 1) * share})") in rec["trainer_out"]
        # one fused step per rank: the record counts both ranks' games
        assert rec["trainer_record"]["epoch_steps"] == 1
        assert rec["trainer_record"]["anakin_games"] == NUM_ENVS
    assert (recs[0]["trainer_record"]["anakin_frames"]
            == recs[1]["trainer_record"]["anakin_frames"])


def test_ranks_on_two_hosts_keep_the_multi_host_fallback(two_ranks):
    recs, _ = two_ranks
    for rec in recs:
        assert rec["two_hosts_one_host"] is False
        assert not rec["auto_anakin"] and rec["auto_ring"]
        assert (f"WARNING: {FALLBACK}; falling back to the worker path"
                in rec["auto_out"])
        assert rec["on_error"] == "anakin.mode: on — " + FALLBACK
