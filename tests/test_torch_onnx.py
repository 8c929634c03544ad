"""ONNX interop of the port, and its SWA and ``.npz`` tools.

The same seeded Flax params (``random_flax_params``) go into the
port's net (``from_flax``) and the JAX package's; each package exports
its net to ``.onnx``.  Then, per net (TicTacToe, HungryGeese, Geister
and GRFProxy at narrow widths, GeeseNet at its published 32 x 12):
  * the port's file, run by the port's numpy runner, equals the port's
    forward within atol 1e-5, rtol 1e-5: both are exact float32 on the
    CPU;
  * the port's file and the JAX package's, run by the same runner,
    agree within atol 1e-5, rtol 1e-4: only the order of operations
    differs (GroupNorm's variance, layout transposes);
  * each package's runner reads the other package's file;
  * against the JAX module's own forward the tolerance is
    ``tests/test_onnx.py``'s: jax's CPU convolutions run oneDNN's
    reduced-precision fast math (~1e-2 relative against float64),
    while the numpy runner is exact float32, so rtol 2e-2, atol 2e-3;
  * Geister carries its hidden state for 3 steps, equal to the port's
    ``TorchModel`` hidden within 1e-5.
Also: ``onnx_proto.encode`` gives the JAX package's bytes, ``.onnx``
models play full games through ``load_model``, ``aux_swa`` equals
``scripts/aux_swa.py`` bit for bit, and the JAX package's
``load_model`` reads the port's ``swa.ckpt`` and ``.npz``.
"""

import importlib.util
import os

import numpy as np
import pytest
import torch

from handyrl_tpu.interop import onnx_proto as jax_proto
from handyrl_tpu.interop.onnx_export import export_onnx as jax_export
from handyrl_tpu.interop.onnx_run import OnnxModel as JaxOnnxModel
from handyrl_tpu.models import TPUModel
from handyrl_tpu_torch.agent import Agent, RandomAgent
from handyrl_tpu_torch.durability import read_verified, write_checksummed
from handyrl_tpu_torch.environment import make_env
from handyrl_tpu_torch.evaluation import exec_match, load_model
from handyrl_tpu_torch.interop import onnx_proto
from handyrl_tpu_torch.interop.onnx_export import export_onnx
from handyrl_tpu_torch.interop.onnx_run import OnnxModel
from handyrl_tpu_torch.models import TorchModel
from handyrl_tpu_torch.models.convert import random_flax_params
from handyrl_tpu_torch.utils.tree import tree_flatten, tree_leaves
from torchfix import one_torch_thread, twin_nets  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SELF_TOL = dict(rtol=1e-5, atol=1e-5)    # exact float32, both on the CPU
CROSS_TOL = dict(rtol=1e-4, atol=1e-5)   # two files, one runner
ONEDNN_TOL = dict(rtol=2e-2, atol=2e-3)  # jax CPU conv fast math
HIDDEN_TOL = 1e-5
# runner ops both packages execute; the port's exports use no other
RUNNER_OPS = {"Conv", "MatMul", "Add", "Sub", "Mul", "Div", "Relu",
              "LeakyRelu", "Tanh", "Sigmoid", "Identity", "Reshape",
              "Transpose", "Concat", "Split", "Slice", "Expand",
              "ReduceMean", "ReduceSum", "Sqrt", "Pad"}

CASES = ["TicTacToe", "HungryGeese", "Geister", "GRFProxy",
         "GeeseNet32x12"]


def _nets(case):
    """(env name, flax module, torch module, flax params)."""
    if case == "GeeseNet32x12":
        from handyrl_tpu.models.geese_net import GeeseNet as FlaxGeese
        from handyrl_tpu_torch.models.geese_net import GeeseNet

        net = GeeseNet(filters=32, blocks=12)
        params = random_flax_params(net, seed=3)
        return ("HungryGeese", FlaxGeese(filters=32, blocks=12), net,
                params)
    flax_net, torch_net, params = twin_nets(case, seed=1)
    return case, flax_net, torch_net, params


def _observations(env_name, n, seed):
    """``n`` observations of successive states of seeded games (the
    first player's view)."""
    rng = np.random.default_rng(seed)
    env = make_env({"env": env_name})
    env.reset()
    obs = []
    while len(obs) < n:
        if env.terminal():
            env.reset()
        obs.append(env.observation(env.players()[0]))
        actions = {}
        for p in env.turns():
            legal = env.legal_actions(p)
            actions[p] = legal[int(rng.integers(len(legal)))]
        env.step(actions)
    return obs


@pytest.fixture(scope="module")
def exported(tmp_path_factory):
    """Per case: the twin models and both packages' files."""
    out = {}
    root = tmp_path_factory.mktemp("onnx")
    for case in CASES:
        env_name, flax_net, torch_net, params = _nets(case)
        port = TorchModel.from_flax(torch_net, params, device="cpu")
        jax_model = TPUModel(flax_net, params)
        obs = _observations(env_name, 3, seed=7)
        paths = (str(root / f"{case}_port.onnx"),
                 str(root / f"{case}_jax.onnx"))
        export_onnx(port, obs[0], paths[0])
        jax_export(jax_model, obs[0], paths[1])
        out[case] = (port, jax_model, obs, paths)
    return out


def _heads(out):
    return {k: v for k, v in out.items() if k != "hidden"}


def _close(a, b, tol, what):
    assert set(a) == set(b), what
    for k in a:
        np.testing.assert_allclose(np.asarray(a[k], np.float32),
                                   np.asarray(b[k], np.float32),
                                   err_msg=f"{what}: {k}", **tol)


@pytest.mark.parametrize("case", CASES)
def test_port_file_equals_the_port_forward(exported, case):
    port, _, obs, (path, _) = exported[case]
    runner = OnnxModel(path)
    for o in obs:
        ref = port.inference(o, port.init_hidden())
        out = runner.inference(o, runner.init_hidden())
        _close(_heads(out), _heads(ref), SELF_TOL, case)


@pytest.mark.parametrize("case", CASES)
def test_port_and_jax_files_agree_under_each_runner(exported, case):
    _, _, obs, (port_path, jax_path) = exported[case]
    for runner_cls in (OnnxModel, JaxOnnxModel):
        a, b = runner_cls(port_path), runner_cls(jax_path)
        for o in obs:
            out_a = a.inference(o, a.init_hidden())
            out_b = b.inference(o, b.init_hidden())
            _close(_heads(out_a), _heads(out_b), CROSS_TOL,
                   f"{case} under {runner_cls.__module__}")
            for ha, hb in zip(out_a["hidden"] or [], out_b["hidden"] or []):
                np.testing.assert_allclose(ha, hb, **CROSS_TOL)


@pytest.mark.parametrize("case", CASES)
def test_files_share_names_shapes_and_ops(exported, case):
    graphs = []
    for path in exported[case][3]:
        with open(path, "rb") as f:
            model = onnx_proto.decode(f.read(), "Model")
        assert model["ir_version"] == 8
        assert model["opset_import"][0]["version"] == 17
        graphs.append(model["graph"])
    port, jax = graphs
    for field in ("input", "output"):
        assert ([(vi["name"], OnnxModel._vi_shape(vi)) for vi in port[field]]
                == [(vi["name"], OnnxModel._vi_shape(vi))
                    for vi in jax[field]])
    assert {n["op_type"] for n in port["node"]} <= RUNNER_OPS
    assert all(t["data_type"] in (onnx_proto.DT_FLOAT, onnx_proto.DT_INT64)
               for t in port["initializer"])


@pytest.mark.parametrize("case", CASES)
def test_port_file_against_the_jax_forward(exported, case):
    _, jax_model, obs, (path, _) = exported[case]
    runner = JaxOnnxModel(path)
    for o in obs:
        ref = jax_model.inference(o, jax_model.init_hidden())
        out = runner.inference(o, runner.init_hidden())
        _close(_heads(out), {k: np.asarray(v) for k, v in
                             _heads(ref).items()}, ONEDNN_TOL, case)


def test_geister_carries_its_hidden_state_for_three_steps(exported):
    port, _, obs, (path, _) = exported["Geister"]
    runner = OnnxModel(path)
    hidden, carried = port.init_hidden(), runner.init_hidden()
    names = [vi["name"] for vi in runner._hidden_inputs]
    assert names == [f"hidden_{i}" for i in range(len(names))] and names
    for step, o in enumerate(obs):
        ref = port.inference(o, hidden)
        out = runner.inference(o, carried)
        _close(_heads(out), _heads(ref), SELF_TOL, f"step {step}")
        hidden, carried = ref["hidden"], out["hidden"]
        want = tree_leaves(hidden)   # the sorted-key order of the dict
        assert len(carried) == len(want)
        for a, b in zip(carried, want):
            assert a.shape == b.shape and a.dtype == np.float32
            np.testing.assert_allclose(a, b, rtol=0, atol=HIDDEN_TOL)
        assert any(np.abs(h).max() > 0 for h in carried)


def test_initializers_are_the_float32_parameters(
        tmp_path):
    """The initializers are the module's float32 parameters, bit for
    bit, however the net was trained."""
    env = make_env({"env": "TicTacToe"})
    env.reset()
    model = TorchModel(env.net(), device="cpu")
    model.init_params(seed=4)
    path = str(tmp_path / "t.onnx")
    export_onnx(model, env.observation(0), path)
    with open(path, "rb") as f:
        graph = onnx_proto.decode(f.read(), "Model")["graph"]
    stem = model.module.stem.weight.detach().numpy()
    blobs = {t["raw_data"] for t in graph["initializer"]}
    assert stem.astype(np.float32).tobytes() in blobs


def test_unmapped_torch_calls_are_named(tmp_path):
    class Net(torch.nn.Module):
        def forward(self, obs, hidden=None):
            return {"policy": torch.exp(obs), "value": obs.sum(1)}

    model = TorchModel(Net(), device="cpu")
    with pytest.raises(NotImplementedError, match="exp"):
        export_onnx(model, np.zeros(3, np.float32),
                    str(tmp_path / "x.onnx"))


MESSAGES = [
    {"ir_version": 8, "producer_name": "p", "model_version": -3,
     "opset_import": [{"domain": "", "version": 17}],
     "graph": {"name": "g", "node": [
         {"op_type": "Conv", "input": ["x", "w"], "output": ["y"],
          "attribute": [
              {"name": "pads", "type": 7, "ints": [1, 0, -1, 2 ** 40]},
              {"name": "alpha", "type": 1, "f": 0.1},
              {"name": "mode", "type": 3, "s": b"wrap"}]}],
         "initializer": [{"name": "w", "dims": [2, 3], "data_type": 1,
                          "raw_data": np.arange(6, dtype=np.float32)
                          .tobytes()},
                         {"name": "f", "dims": [2], "data_type": 1,
                          "float_data": [1.5, -2.25]}],
         "input": [{"name": "x", "type": {"tensor_type": {
             "elem_type": 1, "shape": {"dim": [{"dim_value": 1},
                                               {"dim_param": "n"}]}}}}],
         "output": []}},
    {"ir_version": 3, "doc_string": "ünïcode", "graph": {"name": ""}},
]


@pytest.mark.parametrize("index", range(len(MESSAGES)))
def test_onnx_proto_bytes_match_the_jax_codec(index):
    msg = MESSAGES[index]
    blob = onnx_proto.encode(msg, "Model")
    assert blob == jax_proto.encode(msg, "Model")
    assert onnx_proto.decode(blob, "Model") == jax_proto.decode(
        blob, "Model")


def test_load_model_plays_full_games_with_an_onnx_file(exported):
    env = make_env({"env": "TicTacToe"})
    model = load_model(exported["TicTacToe"][3][0], env, device="cpu")
    assert isinstance(model, OnnxModel)
    results = [exec_match(env, {0: Agent(model), 1: RandomAgent()})
               for _ in range(3)]
    results += [exec_match(env, {0: RandomAgent(), 1: Agent(model)})
                for _ in range(2)]
    assert all(r is not None for r in results)
    assert all(-1.0 <= r[0] <= 1.0 for r in results)


# -- SWA and .npz export ---------------------------------------------------

def _jax_script(name):
    spec = importlib.util.spec_from_file_location(
        f"jax_script_{name}", os.path.join(REPO, "scripts", f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture
def run_dir(tmp_path, monkeypatch):
    """Three epoch checkpoints of TicTacToeNet in the port's checksummed
    format, and the shipped env in config.yaml."""
    from handyrl_tpu_torch.models.tictactoe_net import TicTacToeNet

    monkeypatch.chdir(tmp_path)
    os.makedirs("models")
    for epoch in (1, 2, 3):
        write_checksummed(f"models/{epoch}.ckpt", {
            "params": random_flax_params(TicTacToeNet(), seed=epoch),
            "epoch": epoch, "steps": 10 * epoch})
    with open("config.yaml", "w") as f:
        f.write("env_args:\n    env: 'TicTacToe'\n")
    return tmp_path


def test_swa_equals_the_jax_script_bit_for_bit(run_dir):
    from handyrl_tpu_torch.scripts import aux_swa

    paths = [f"models/{e}.ckpt" for e in (1, 2, 3)]
    ours = aux_swa.average_checkpoints(paths)
    theirs = _jax_script("aux_swa").average_checkpoints(paths)
    a, treedef = tree_flatten(ours)
    b, jax_treedef = tree_flatten({k: v for k, v in theirs.items()})
    assert treedef == jax_treedef
    for x, y in zip(a, b):
        assert x.dtype == np.float32
        assert np.array_equal(x, np.asarray(y)) and x.tobytes() == \
            np.asarray(y).tobytes()

    assert aux_swa.main(["1", "3"]) == 0
    state = read_verified("models/swa.ckpt")   # checksummed
    assert state["swa"] is True and state["epoch"] == 3
    for x, y in zip(tree_leaves(state["params"]), a):
        assert np.array_equal(x, y)


def test_jax_load_model_reads_the_port_swa_and_npz(run_dir):
    from handyrl_tpu.environment import make_env as jax_make_env
    from handyrl_tpu.evaluation import load_model as jax_load_model
    from handyrl_tpu_torch.scripts import aux_swa, export_model

    assert aux_swa.main(["1", "3", "2"]) == 0     # epochs 1 and 3
    assert export_model.main(["models/swa.ckpt"]) == 0
    jenv, env = jax_make_env({"env": "TicTacToe"}), make_env(
        {"env": "TicTacToe"})
    env.reset()
    obs = env.observation(0)
    swa = read_verified("models/swa.ckpt")["params"]
    for path in ("models/swa.ckpt", "models/swa.npz"):
        jmodel = jax_load_model(path, jenv)
        for x, y in zip(tree_leaves(swa), tree_leaves(jmodel.params)):
            assert np.array_equal(x, np.asarray(y))
        port = load_model(path, env, device="cpu")
        jout, out = jmodel.inference(obs), port.inference(obs)
        for key in ("policy", "value"):
            np.testing.assert_allclose(out[key], np.asarray(jout[key]),
                                       **ONEDNN_TOL)
    with np.load("models/swa.npz") as archive:
        import json

        header = json.loads(archive["__header__"].tobytes().decode())
    assert header["env"] == "TicTacToe" and header["epoch"] == 3


def test_make_onnx_model_refuses_a_missing_card(run_dir):
    from handyrl_tpu_torch.scripts import make_onnx_model

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; this checks its absence")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make_onnx_model.main(["models/3.ckpt"])
    assert make_onnx_model.main(["models/3.ckpt", "m.onnx",
                                 "--device", "cpu"]) == 0
    env = make_env({"env": "TicTacToe"})
    env.reset()
    obs = env.observation(0)
    ref = load_model("models/3.ckpt", env, device="cpu").inference(obs)
    out = OnnxModel("m.onnx").inference(obs)
    _close(_heads(out), ref, SELF_TOL, "make_onnx_model")
