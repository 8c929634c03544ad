"""The port's run tools against the repository's ``scripts/``.

``handyrl_tpu_torch.scripts.perf_ledger`` and ``.plot_metrics`` are
copies of ``scripts/perf_ledger.py`` and ``scripts/plot_metrics.py``:

  * the same bench JSON and metrics fixtures through both perf ledgers
    give the same ledger lines, the same ``--check`` verdicts and exit
    codes, and the same run-directory summaries (the cases of
    tests/test_perf.py's ledger section);
  * both plot tools parse the same stdout log and metrics jsonl into
    the same records and series, the guard keys of a port run
    included; where matplotlib is installed both render the same file
    names;
  * the port's tools import only the standard library at module level.
"""

import ast
import importlib.util
import json
import os
import subprocess
import sys

import pytest

from handyrl_tpu_torch.scripts import perf_ledger as tledger
from handyrl_tpu_torch.scripts import plot_metrics as tplot
from torchfix import CHILD_ENV, one_torch_thread  # noqa: F401  (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _load(name):
    spec = importlib.util.spec_from_file_location(
        f"repo_scripts_{name}", os.path.join(REPO, "scripts", f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


jledger = _load("perf_ledger")
jplot = _load("plot_metrics")
LEDGERS = {"jax": jledger, "port": tledger}


def _both(fn, tmp_path):
    out = {}
    for tag, module in LEDGERS.items():
        root = tmp_path / tag
        root.mkdir()
        out[tag] = fn(module, root)
    assert out["port"] == out["jax"]
    return out["port"]


def _ledger_lines(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


def test_ledger_append_from_bench_json_and_check_green(tmp_path, capsys):
    def run(m, root):
        bench = root / "bench_pipeline.json"
        bench.write_text(json.dumps({
            "metric": "pipeline_e2e_speedup", "value": 1.4,
            "unit": "ratio", "learner_steps_per_sec_e2e_pipelined": 20.0,
            "flag": True}))
        ledger = str(root / "ledger.jsonl")
        rc = m.main([str(bench), "--ledger", ledger, "--ts", "1"])
        rc2 = m.main(["--check", "--ledger", ledger])
        out = capsys.readouterr().out.replace(str(root), "<root>")
        return rc, rc2, _ledger_lines(ledger), out

    rc, rc2, lines, out = _both(run, tmp_path)
    assert (rc, rc2) == (0, 0)
    assert lines == [{"ts": 1.0, "source": "pipeline_e2e_speedup",
                      "metrics": {"value": 1.4,
                                  "learner_steps_per_sec_e2e_pipelined":
                                  20.0}}]
    assert "no regressions" in out


@pytest.mark.parametrize("key,values,tolerance,rc", [
    ("steps_per_sec", [10.0, 10.2, 9.8, 10.1, 5.0], 0.25, 1),
    ("steps_per_sec", [10.0, 10.2, 9.8, 10.1, 9.0], 0.25, 0),
    ("chaos_recovery_sec", [1.0, 1.1, 0.9, 3.0], 0.25, 1),
    ("chaos_recovery_sec", [3.0, 1.1, 0.9, 1.0], 0.25, 0),
    ("mystery_number", [1.0, 1.0, 1.0, 99.0], 0.25, 0),
    ("serve_p99_ms", [2.0, 2.1, 1.9, 2.6], 0.1, 1),
])
def test_ledger_check_verdicts_match(tmp_path, capsys, key, values,
                                     tolerance, rc):
    def run(m, root):
        path = str(root / "ledger.jsonl")
        for i, value in enumerate(values):
            m.append_entry(path, "bench", {key: value}, ts=i)
        code = m.main(["--check", "--ledger", path,
                       "--tolerance", str(tolerance)])
        out = capsys.readouterr().out.replace(str(root), "<root>")
        failures, lines = m.check(m.read_ledger(path),
                                  tolerance=tolerance)
        return code, out, failures, lines, _ledger_lines(path)

    code, out, failures, _lines, _ = _both(run, tmp_path)
    assert code == rc and bool(failures) == bool(rc)
    assert ("REGRESS" in out) == bool(rc)


def _metrics_fixture(root, guard_keys=False):
    records = []
    for epoch in range(4):
        rec = {"epoch": epoch, "steps": 100 * (epoch + 1),
               "epoch_wall_sec": 10.0, "mfu": 0.1 + epoch * 0.01,
               "achieved_tflops": 1.5 + epoch,
               "batch_wait_sec": 2.0, "untracked_residual_sec": 1.0,
               "p": 0.5 - 0.1 * epoch, "v": 0.3, "ent": 1.0,
               "total": 0.8, "win_rate": 0.5 + 0.05 * epoch}
        if guard_keys:
            rec.update(retrace_count=1, host_transfers=3 + epoch,
                       nonfinite_steps=0, numerics_contract_breaks=0,
                       weak_upcasts=0, stall_events=0,
                       lock_contention_sec=0.01 * epoch,
                       lock_order_inversions=0, fd_count=40,
                       thread_count=12, shm_segments=20,
                       resource_growth=0, episodes_shm=10 + epoch,
                       episodes_spilled=epoch, upload_backlog=2 * epoch,
                       resharding_copies=0)
        records.append(rec)
    (root / "metrics.jsonl").write_text(
        "".join(json.dumps(r) + "\n" for r in records))
    return records


def test_ledger_summarizes_run_directories(tmp_path):
    def run(m, root):
        run_dir = root / "run"
        run_dir.mkdir()
        _metrics_fixture(run_dir, guard_keys=True)
        return m.load_source(str(run_dir))

    source, metrics = _both(run, tmp_path)
    assert source == "run"
    assert metrics["steps_per_sec"] == pytest.approx(10.0)
    assert metrics["mfu"] == pytest.approx(0.115)
    assert metrics["batch_wait_share"] == pytest.approx(0.2)
    assert metrics["residual_share"] == pytest.approx(0.1)


def test_ledger_cli_in_a_subprocess_matches(tmp_path):
    """The CLI as run from a shell: the same lines and exit codes."""
    run_dir = tmp_path / "run"
    run_dir.mkdir()
    _metrics_fixture(run_dir)
    outs = {}
    for tag, cmd in (
            ("jax", [sys.executable, os.path.join(REPO, "scripts",
                                                  "perf_ledger.py")]),
            ("port", [sys.executable, "-m",
                      "handyrl_tpu_torch.scripts.perf_ledger"])):
        ledger = str(tmp_path / f"{tag}.jsonl")
        codes = [subprocess.run(
            cmd + [str(run_dir), "--ledger", ledger, "--source", "r",
                   "--ts", str(i)], cwd=REPO,
            env=dict(CHILD_ENV, PYTHONPATH=REPO), capture_output=True,
            text=True, timeout=60).returncode for i in range(3)]
        check = subprocess.run(
            cmd + ["--check", "--ledger", ledger], cwd=REPO,
            env=dict(CHILD_ENV, PYTHONPATH=REPO), capture_output=True,
            text=True, timeout=60)
        outs[tag] = (codes, check.returncode,
                     check.stdout.replace(ledger, "<ledger>"),
                     _ledger_lines(ledger))
    assert outs["port"] == outs["jax"]
    assert outs["port"][:2] == ([0, 0, 0], 0)


# -- plot_metrics --------------------------------------------------------

STDOUT_LOG = """\
started server
epoch 0
win rate = 0.550 (11.0 / 20)
loss = p:0.100 v:0.200 ent:1.500 total:0.300
generation stats = 0.010 +- 0.950
updated model(100)

epoch 1
win rate (total) = 0.600 (12.0 / 20)
win rate (random) = 0.600 (12.0 / 20)
loss = p:0.050 v:0.150 ent:1.400 total:0.200
generation stats = -0.020 +- 0.900
updated model(200)
"""


@pytest.mark.parametrize("source", ["jsonl", "stdout"])
def test_plot_metrics_parses_and_extracts_series_alike(tmp_path, source):
    if source == "jsonl":
        _metrics_fixture(tmp_path, guard_keys=True)
        path = str(tmp_path / "metrics.jsonl")
        jparsed, tparsed = jplot.parse_jsonl(path), tplot.parse_jsonl(path)
    else:
        path = tmp_path / "train.log"
        path.write_text(STDOUT_LOG)
        jparsed = jplot.parse_stdout_log(str(path))
        tparsed = tplot.parse_stdout_log(str(path))
    assert tparsed == jparsed and len(tparsed) >= 2
    xs = [e.get("epoch", i) for i, e in enumerate(tparsed)]
    keys = sorted({k for e in tparsed for k in e} | {"resharding_copies"})
    for key in keys:
        assert tplot.series(xs, tparsed, key) == \
            jplot.series(xs, jparsed, key), key
    # a port run writes resharding_copies as the JAX learner does (the
    # stdout log carries none), and every guard key of the record is a
    # plotted point
    want = [(e, 0) for e in range(4)] if source == "jsonl" else []
    assert tplot.series(xs, tparsed, "resharding_copies") == want
    if source == "jsonl":
        assert tplot.series(xs, tparsed, "host_transfers") == \
            [(0, 3), (1, 4), (2, 5), (3, 6)]
    assert tplot.moving_average([1.0, 2.0, 3.0, 4.0], 3) == \
        jplot.moving_average([1.0, 2.0, 3.0, 4.0], 3)


def test_plot_metrics_renders_the_same_files(tmp_path, capsys):
    pytest.importorskip("matplotlib")
    _metrics_fixture(tmp_path, guard_keys=True)
    epochs = tplot.parse_jsonl(str(tmp_path / "metrics.jsonl"))
    tplot.plot(epochs, str(tmp_path / "port"))
    jplot.plot(jplot.parse_jsonl(str(tmp_path / "metrics.jsonl")),
               str(tmp_path / "jax"))
    files = sorted(os.listdir(tmp_path))
    port = sorted(f[len("port"):] for f in files if f.startswith("port"))
    jax = sorted(f[len("jax"):] for f in files if f.startswith("jax"))
    assert port == jax and "_guards.png" in port
    capsys.readouterr()


def test_run_tools_import_only_the_standard_library():
    stdlib = set(sys.stdlib_module_names)
    for module in (tledger, tplot):
        tree = ast.parse(open(module.__file__).read())
        top = [node for node in tree.body
               if isinstance(node, (ast.Import, ast.ImportFrom))]
        names = {alias.name.split(".")[0] for node in top
                 for alias in node.names if isinstance(node, ast.Import)}
        names |= {node.module.split(".")[0] for node in top
                  if isinstance(node, ast.ImportFrom) and node.module}
        assert names <= stdlib, (module.__name__, names - stdlib)
