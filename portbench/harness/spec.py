"""What a cell is made of, found by name.

``BENCHMARK.json`` at the checkout's root names the cells; each piece
of one lives in a file of its own under ``portbench/``:

  configs/<config>.json    the configuration as it is run
  refs/<config>.py         its plain float32 reference net
  costs/<config>.py        its analytic FLOPs and bytes per step
  games/<game>.py          the observation planes of its game
  traffic/<traffic>.json   the traffic mix (batch, stream, epochs)
  limits/<workload>.json   the correctness limits of the cell
  metrics/<metric>.py      the reader of one per-layer metric

so a cell or a metric is added by adding files and entries.
"""

import importlib
import json
import os
from dataclasses import dataclass

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
HERE = os.path.join(ROOT, "portbench")


def _json(*parts):
    with open(os.path.join(*parts)) as f:
        return json.load(f)


@dataclass
class Cell:
    workload: dict
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list
    per_layer: list

    @property
    def name(self):
        return self.workload["name"]

    @property
    def train_args(self):
        """The learner's ``train_args``: the configuration's, with the
        traffic's batch and epoch length."""
        t = self.traffic
        return dict(self.config["train_args"],
                    batch_size=t["batch_windows"],
                    updates_per_epoch=t["epoch_steps"])

    def metrics(self, kind):
        """The cell's ``end_to_end`` or ``per_layer`` entries."""
        entries = self.end_to_end if kind == "end_to_end" else self.per_layer
        return [m for m in entries
                if self.name in m.get("workloads", [self.name])]

    def costs(self):
        mod = importlib.import_module(
            f"portbench.costs.{self.config['name']}")
        args = self.train_args
        return mod.step(self.config["net"]["config"], args["batch_size"],
                        args.get("burn_in_steps", 0),
                        args["forward_steps"])


def load(workload, bench_path=None):
    bench = _json(bench_path or os.path.join(ROOT, "BENCHMARK.json"))
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}; known: "
                         f"{sorted(cells)}")
    w = cells[workload]
    configs = {c["name"]: c for c in bench["configs"]}
    return Cell(
        workload=w,
        config=_json(ROOT, configs[w["config"]]["file"]),
        traffic=_json(HERE, "traffic", w["traffic"] + ".json"),
        limits=_json(HERE, "limits", workload + ".json"),
        end_to_end=bench["end_to_end"],
        per_layer=bench["per_layer"])


def reader(metric_name):
    return importlib.import_module(f"portbench.metrics.{metric_name}")
