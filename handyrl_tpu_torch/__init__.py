"""handyrl_tpu_torch — the PyTorch/CUDA port of ``handyrl_tpu``.

A second package beside the JAX one, module for module under the same
names, so a reader finds each counterpart.  It imports ``torch`` and
numpy and nothing of JAX or of ``handyrl_tpu``: what it needs of the
JAX package's framework-free modules (env rules, agents, the shm
transport) it keeps as its own copy.

Every entry point takes an explicit ``device`` (default ``"cuda"``);
asking for the card where there is none raises (see :mod:`.device`).
Observations stay channel-last (NHWC) at every public surface, as the
envs emit them; the nets permute to NCHW inside.
"""

__version__ = "0.1.0"
