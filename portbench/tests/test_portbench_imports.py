"""What a benchmark run loads: no JAX, and a reference free of the port.

Each check runs in a fresh interpreter, so nothing this test process
imported (the repository's own tests import JAX beside the port)
leaks into it.  Module names are compared by their whole top-level
name: ``handyrl_tpu_torch`` begins with ``handyrl_tpu`` but is not it.
"""

import json
import subprocess
import sys

from portbench.harness import spec

FORBIDDEN = ["jax", "jaxlib", "flax", "optax", "handyrl_tpu"]


def loaded_after(code):
    prog = (f"import sys\nsys.path.insert(0, {spec.ROOT!r})\n{code}\n"
            "import json\n"
            "print(json.dumps(sorted({m.split('.')[0] for m in "
            "sys.modules})))\n")
    proc = subprocess.run([sys.executable, "-c", prog], capture_output=True,
                          text=True, timeout=300, cwd=spec.ROOT)
    assert proc.returncode == 0, proc.stderr[-2000:]
    return set(json.loads(proc.stdout.strip().splitlines()[-1]))


def test_harness_and_set_up_load_no_jax():
    top = loaded_after(
        "import portbench.run\n"
        "from portbench.harness import cell, check, drive, spec, trace\n"
        "import torch\n"
        "for w in ('geese_ring_b16k', 'grf_ring_b20k'):\n"
        "    c = spec.load(w)\n"
        "    m = drive.new_module(c)\n"
        "    for r in c.per_layer + c.end_to_end:\n"
        "        spec.reader(r['name'])\n"
        "import handyrl_tpu_torch.learner\n")
    assert "handyrl_tpu_torch" in top
    assert not top & set(FORBIDDEN), sorted(top & set(FORBIDDEN))


def test_reference_loads_nothing_of_the_port():
    top = loaded_after(
        "from portbench.refs import train, geese_32x12, grf_drc_1x2\n"
        "from portbench.games import hungry_geese, grf_smm\n"
        "from portbench.costs import geese_32x12, grf_drc_1x2\n")
    assert "handyrl_tpu_torch" not in top
    assert not top & set(FORBIDDEN)
