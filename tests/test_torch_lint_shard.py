"""torchlint's shard family: the lintfix contract on the torch fixtures,
flagged lines against the JAX fixtures, and the port's mesh model.

The JAX family reads ``Mesh``/``PartitionSpec``/``shard_map``; the port
builds a ``DeviceMesh`` with ``mesh_dim_names=AXES``, places tensors
with ``Shard(d)``/``Replicate()`` tuples and reduces over
``mesh.get_group(...)``.  The last test checks that the analysis of the
port itself is populated — the axes, the process groups held on
``self``, the functions that run collectives and the rank-dependent
``self.primary`` — or the clean gate would be vacuous.
"""

import os

import pytest
from test_torch_lint_base import (
    PACKAGE,
    assert_line_parity,
    check_contract,
    torch_fixture,
)

from handyrl_tpu_torch.analysis import torchlint
from handyrl_tpu_torch.analysis.shardlint import analyze
from handyrl_tpu_torch.analysis.shardrules import SHARD_RULES

RULE_IDS = sorted(SHARD_RULES)

TORCH_ONLY = {
    "divergent-control": {43: "DTensor.full_tensor() (a gather) under a "
                              "self.primary branch"},
    "unsynced-divisibility": {20: "a time split by an axis size, the sp "
                                  "split of parallel/update.py"},
}


@pytest.mark.parametrize("kind", ["pos", "neg", "supp"])
@pytest.mark.parametrize("rule_id", RULE_IDS)
def test_rule_fixture(rule_id, kind):
    check_contract(torch_fixture("shard", rule_id, kind), rule_id, kind,
                   shard=True)


@pytest.mark.parametrize("jax_id", RULE_IDS)
def test_flagged_lines_match_the_jax_fixture(jax_id):
    assert_line_parity("shardlint", "shard", jax_id, {"shard": True}, {},
                       TORCH_ONLY)


def test_shard_registry_keeps_the_jax_ids():
    from handyrl_tpu.analysis.shardrules import SHARD_RULES as JAX_SHARD

    assert set(RULE_IDS) == set(JAX_SHARD)


def test_a_package_without_a_mesh_is_not_judged():
    src = ("import torch.distributed as dist\n"
           "def f(mesh, x):\n"
           "    dist.all_reduce(x)\n"
           "    return mesh.get_group('anything')\n")
    assert torchlint.lint_source(src, shard=True) == []


def test_placements_repeat_by_the_axis_count():
    src = ("from torch.distributed.device_mesh import init_device_mesh\n"
           "from torch.distributed.tensor import Replicate\n"
           "AXES = ('dp', 'sp', 'tp')\n"
           "def mesh():\n"
           "    return init_device_mesh('cuda', (1, 1, 1),\n"
           "                            mesh_dim_names=AXES)\n"
           "def replicated():\n"
           "    return (Replicate(),) * len(AXES)\n"
           "def short():\n"
           "    return (Replicate(),) * 2\n")
    findings = torchlint.lint_source(src, shard=True)
    assert [(f.rule, f.line) for f in findings] == [("axis-reuse", 10)]


def test_the_port_mesh_model_is_populated():
    package, _supp, _err = torchlint.load_package([PACKAGE])
    an = analyze(package)
    assert an.mesh_order == ("dp", "sp", "tp")
    groups = an.group_attrs[("handyrl_tpu_torch.parallel.update",
                             "ShardedUpdateStep")]
    assert groups["dp_group"] == "dp" and groups["sp_group"] == "sp"
    collective = {fn.qname.split(":")[1] for fn in an.collective_fns
                  if fn.module.name.endswith(("parallel.update",
                                              "parallel.multihost"))}
    assert {"sync_epoch_code", "broadcast_train_state",
            "ShardedUpdateStep._sum_metrics"} <= collective
    learner = "handyrl_tpu_torch.learner"
    assert "primary" in an.divergent_attrs[(learner, "Learner")]
    assert any(fn.qname.endswith(":process_index")
               for fn in an.divergent_returns)
    assert os.path.isdir(PACKAGE)
