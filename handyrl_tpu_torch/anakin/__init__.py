"""handyrl_tpu_torch.anakin — fused on-device rollout + update.

The counterpart of ``handyrl_tpu.anakin`` (Podracer's Anakin
architecture, arXiv:2104.06272): for envs with a batched device twin in
``environment.DEVICE_ENV_REGISTRY``, env stepping, inference, batch
assembly and the optimizer update run on the training device in one
step per call, with no host round trip; the worker fleet only
evaluates.

Public surface: :class:`AnakinConfig` (the validated ``anakin.*`` keys)
and :class:`AnakinEngine` (which makes the fused step the Trainer drives).
"""

from .config import AnakinConfig  # noqa: F401
from .rollout import AnakinEngine  # noqa: F401
