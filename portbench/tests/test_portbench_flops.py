"""The analytic FLOPs of ``portbench/costs`` against PyTorch's counter.

At a small size, one training step of the plain reference net (forward
over every row, backward over the trained rows, burn-in included for
the recurrent net) under ``torch.utils.flop_counter.FlopCounterMode``
counts exactly what the cost file computes from the shapes."""

import importlib

import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from portbench.harness import drive, episodes, weights
from portbench.refs import train as ref_train
from portbench.tests.tiny import tiny_cell


@pytest.mark.parametrize("workload", ["geese_ring_b16k", "grf_ring_b20k"])
@pytest.mark.parametrize("net", [None, "wider"])
def test_analytic_flops_match_the_counter(workload, net):
    cell = tiny_cell(workload, windows=3)
    if net:
        cfg = cell.config["net"]["config"]
        cfg["filters"] = 16
        cfg.setdefault("blocks", 3)
        if "drc_layers" in cfg:
            cfg.update(drc_layers=2, drc_repeats=3)
            cfg.pop("blocks")
    args = cell.train_args
    _, sources = episodes.make_pool(cell.config, 11, episodes.FILL, 2)
    init = weights.init_state(drive.new_module(cell), 11, "cpu")
    ref = ref_train.Reference(cell.config["name"],
                              cell.config["net"]["config"], args, init,
                              "cpu", block=3)
    B = args["batch_size"]
    rng = np.random.default_rng(3)
    slots = rng.integers(0, 2, B)
    starts = np.zeros(B, np.int64)
    seats = rng.integers(0, sources[0]["present"].shape[1], B)
    burn, fwd = args.get("burn_in_steps", 0), args["forward_steps"]

    def make_block(rows):
        return ref_train.windows(sources, [0, 1], slots[rows],
                                 starts[rows], seats[rows], burn, fwd,
                                 "cpu")

    with FlopCounterMode(display=False) as counter:
        ref.step(make_block, np.arange(B))
    costs = importlib.import_module(f"portbench.costs.{cell.config['name']}")
    want = costs.step(cell.config["net"]["config"], B, burn, fwd)["flops"]
    assert counter.get_total_flops() == want
