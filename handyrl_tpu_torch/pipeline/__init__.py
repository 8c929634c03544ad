"""handyrl_tpu_torch.pipeline — the pipelined rollout dataflow.

The counterpart of ``handyrl_tpu.pipeline``: env stepping stays in CPU
worker processes, inference for every worker runs as ONE batched
forward on the device in :class:`~.service.InferenceService`
(wait-or-timeout request batching, snapshot hot swap), and requests,
replies and finished trajectories travel over the shared-memory rings
of :mod:`.shm`.
"""

from .config import PipelineConfig  # noqa: F401
from .shm import ShmBoard, ShmRing  # noqa: F401
from .service import InferenceService  # noqa: F401
from .client import (  # noqa: F401
    PipelineClient,
    ServedModel,
    attach_pipeline,
    build_obs_spec,
)
