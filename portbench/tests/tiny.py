"""A cell of the benchmark cut to a size a CPU test run holds."""

import copy

from portbench.harness import spec

NETS = {"hungry_geese": {"filters": 8, "blocks": 2},
        "grf_smm": {"filters": 8, "drc_layers": 1, "drc_repeats": 2}}
LENGTHS = {"hungry_geese": [20, 40], "grf_smm": 24}


def tiny_cell(workload, compute_dtype=None, windows=8, full_width=False,
              stream=None):
    """``workload`` at 8-filter widths (``full_width``: the published
    ones), 6 short episodes, ``windows`` windows a step and 5-step
    epochs (``stream``: that many episodes streamed a step); its limits
    are the committed ones."""
    cell = spec.load(workload)
    config = copy.deepcopy(cell.config)
    if not full_width:
        config["net"]["config"] = dict(NETS[config["game"]])
    config["episode_steps"] = LENGTHS[config["game"]]
    config["train_args"].update(minimum_episodes=6, device_replay_mb=64)
    if compute_dtype:
        config["train_args"]["compute_dtype"] = compute_dtype
    cell.config = config
    cell.traffic = dict(cell.traffic, batch_windows=windows, epoch_steps=5,
                        stream_pool=4, warmup_steps=2, trace_steps=4)
    if stream is not None:
        cell.traffic["stream_per_step"] = stream
    return cell
