"""The benchmark's files load by name and hold what its format asks."""

import importlib
import json
import math
import os
import re

import pytest
import torch

from portbench.harness import drive, episodes, spec

BENCH = json.load(open(os.path.join(spec.ROOT, "BENCHMARK.json")))
WORKLOADS = [w["name"] for w in BENCH["workloads"]]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


@pytest.mark.parametrize("workload", WORKLOADS)
def test_cell_loads_by_name(workload):
    cell = spec.load(workload)
    assert cell.config["name"] == cell.workload["config"]
    args = cell.train_args
    assert args["batch_size"] == cell.traffic["batch_windows"]
    assert args["updates_per_epoch"] == cell.traffic["epoch_steps"]
    # every limit names a number the check computes; exact ones are 0
    assert set(cell.limits) <= {"forward_gap", "loss_gap", "count_gap",
                                "delta_flips", "delta_gap", "bad_draws"}
    assert "forward_gap" in cell.limits
    assert cell.limits["bad_draws"]["limit"] == 0
    assert cell.limits["count_gap"]["limit"] == 0
    importlib.import_module(f"portbench.refs.{cell.config['name']}")
    importlib.import_module(f"portbench.games.{cell.config['game']}")
    for kind in ("end_to_end", "per_layer"):
        for m in cell.metrics(kind):
            assert callable(spec.reader(m["name"]).read)


def test_unknown_workload_is_refused():
    with pytest.raises(SystemExit):
        spec.load("no_such_cell")


def test_benchmark_json_shape():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert 1 <= BENCH["run_seconds"] <= 51
    names = [c["name"] for c in BENCH["configs"]]
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("portbench/")
        config = json.load(open(os.path.join(spec.ROOT, c["file"])))
        assert config["reduced"] == c["reduced"]
        for key in c["reduced"]:
            assert key in config and key in config["source_values"]
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["config"] in names and w["chips"] == 1
        assert len(w["why"]) <= 200
    metrics = BENCH["end_to_end"] + BENCH["per_layer"]
    for m in metrics:
        assert NAME.match(m["name"]) and m["better"] in ("lower", "higher")
        assert re.match(r"^[A-Za-z0-9_/%.-]{1,16}$", m["unit"])
        assert set(m.get("workloads", WORKLOADS)) <= set(WORKLOADS)
    assert len({m["name"] for m in metrics}) == len(metrics)
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert e2e["setup_s"]["bound"] == 0.25
    assert all(0.01 <= m["bound"] <= 0.25 for m in e2e.values())
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
        if "roofline" in m["name"]:
            assert m["name"].endswith("_roofline") and m["unit"] == "%"


@pytest.mark.parametrize("workload", WORKLOADS)
def test_costs_count_the_nets_parameters(workload):
    cell = spec.load(workload)
    costs = importlib.import_module(
        f"portbench.costs.{cell.config['name']}")
    module = drive.new_module(cell)
    assert costs.params(cell.config["net"]["config"]) == sum(
        p.numel() for p in module.parameters())
    step = cell.costs()
    assert step["flops"] > 0 and step["bytes"] > 0


@pytest.mark.parametrize("workload", WORKLOADS)
def test_weights_are_seeded_and_bounded(workload):
    from portbench.harness import weights

    cell = spec.load(workload)
    module = drive.new_module(cell)
    a = weights.init_state(module, 2 ** 31 + 5, "cpu")
    b = weights.init_state(module, 2 ** 31 + 5, "cpu")
    c = weights.init_state(module, 2 ** 31 + 6, "cpu")
    assert a.keys() == dict(module.named_parameters()).keys()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert any(not torch.equal(a[k], c[k]) for k in a)
    for name, sub in module.named_modules():
        if isinstance(sub, (torch.nn.Conv2d, torch.nn.Linear)):
            bound = 1 / math.sqrt(sub.weight[0].numel())
            assert a[f"{name}.weight"].abs().max() <= bound


def test_pools_are_kept_and_every_seed_orders_the_same_episodes(tmp_path):
    config = dict(spec.load(WORKLOADS[0]).config, episode_steps=[3, 9])
    drawn = episodes.make_pool(config, 7, episodes.FILL, 5)
    kept = episodes.make_pool(config, 7, episodes.FILL, 5, str(tmp_path))
    again = episodes.make_pool(config, 7, episodes.FILL, 5, str(tmp_path))
    other = episodes.make_pool(config, 8, episodes.FILL, 5, str(tmp_path))
    assert len(os.listdir(tmp_path)) == 1
    for a, b in zip(drawn[1] + kept[1], again[1] + again[1]):
        assert all(torch.equal(torch.as_tensor(a[k]),
                               torch.as_tensor(b[k])) for k in a
                   if k != "n_actions")
    assert drawn[0] == again[0]
    assert sorted(len(s["present"]) for s in other[1]) == [3, 4, 6, 8, 9]
    assert ([len(s["present"]) for s in other[1]]
            != [len(s["present"]) for s in drawn[1]])
