"""Rank-mesh parallelism for the learner (``handyrl_tpu.parallel``'s
counterpart).

The JAX package scales its learner over a ``jax.sharding.Mesh`` of the
devices each controller process sees, and over several controller
processes.  PyTorch runs ONE process per card, so here a mesh always
spans ranks of a ``torch.distributed`` process group: the ``mesh:``
axes (dp, sp, tp and the ``fsdp`` rule) lay out over the ranks that
``distributed:`` brings up, each rank a full learner on its own card.
``--train`` or ``--train-server`` with no ``distributed:`` section on a
host with several cards spawns one rank per card itself (:mod:`.launch`):
the JAX package's auto-dp over a host's local devices.  Ranks that
share one host (:func:`.multihost.one_host`) also run what JAX runs
only on a single-process mesh: Anakin's env axis over dp, and
``--train-server``'s one endpoint, whose rank 0 deals the episodes to
every rank's ring (:mod:`.deal`).  The collectives are
placed by hand around the update step (:mod:`.update`, dp, fsdp, tp and
sp in any combination); the rules deciding which axis of which leaf
shards are the JAX package's (:mod:`.mesh`).
"""

from .mesh import (
    InferenceShardings,
    Layout,
    MeshSpec,
    batch_sharding,
    inference_shardings,
    make_mesh,
    param_sharding,
    replicated,
)
from .multihost import (
    init_distributed,
    is_primary,
    local_batch_size,
    sync_epoch_code,
)
from .update import make_sharded_update_step

__all__ = [
    "InferenceShardings",
    "Layout",
    "MeshSpec",
    "make_mesh",
    "batch_sharding",
    "inference_shardings",
    "param_sharding",
    "replicated",
    "make_sharded_update_step",
    "init_distributed",
    "is_primary",
    "local_batch_size",
    "sync_epoch_code",
]
