"""Rank-mesh parallelism for the learner (``handyrl_tpu.parallel``'s
counterpart).

The JAX package scales its learner over a ``jax.sharding.Mesh`` of the
devices each controller process sees, and over several controller
processes.  PyTorch runs ONE process per card, so here a mesh always
spans ranks of a ``torch.distributed`` process group: the ``mesh:``
axes (dp, sp, tp and the ``fsdp`` rule) lay out over the ranks that
``distributed:`` brings up, each rank a full learner on its own card.
A learner with no ``distributed:`` section uses one card even where the
host has several (it says so, and how to use the rest): the JAX
package's auto-dp over a host's local devices becomes "launch one rank
per card".  The collectives are placed by hand around the update step
(:mod:`.update`); the rules deciding which axis of which leaf shards
are the JAX package's (:mod:`.mesh`).
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
