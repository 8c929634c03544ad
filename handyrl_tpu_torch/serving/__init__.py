"""handyrl_tpu_torch.serving — the SLO-bound network serving tier.

The counterpart of ``handyrl_tpu.serving``: every module is a copy of
its JAX twin but the frontend's feed, which is the port's
``pipeline.InferenceService`` on the card.

A network-facing continuous-batching frontend over the pipeline
inference core (docs/serving.md): remote clients' requests feed the
same ``pipeline.InferenceService`` batching window as the colocated
shm workers, with per-request latency histograms + QPS, SLO-bound
admission control (typed shed replies, never silent drops), and
multi-model routing for epoch-pinned requests (league/opponent-pool
snapshots as first-class serving targets).

Public surface:

  * :class:`.config.ServingConfig` — the validated ``serving.*`` keys;
  * :class:`.config.RouterConfig` — the validated ``router.*`` keys;
  * :class:`.frontend.ServingFrontend` — the learner-side acceptor;
  * :class:`.registry.ServiceRegistry` /
    :class:`.registry.ReplicaAnnouncer` — the pool bulletin and the
    replica-side heartbeat loop (docs/serving.md "Pool routing");
  * :class:`.router.RouterFrontend` — the one-endpoint pool router;
  * :class:`.client.ServeClient` (+ :class:`.client.ShedError` /
    :class:`.client.ServeError`) — the consumer SDK.

The config classes import eagerly (config validation reads them);
everything else resolves lazily (PEP 562) so importing the package
stays cheap for config-only consumers.
"""

from .config import RouterConfig, ServingConfig  # noqa: F401

_LAZY = {
    "ServingFrontend": ("handyrl_tpu_torch.serving.frontend",
                        "ServingFrontend"),
    "ServiceRegistry": ("handyrl_tpu_torch.serving.registry",
                        "ServiceRegistry"),
    "ReplicaAnnouncer": ("handyrl_tpu_torch.serving.registry",
                         "ReplicaAnnouncer"),
    "RouterFrontend": ("handyrl_tpu_torch.serving.router", "RouterFrontend"),
    "ServeClient": ("handyrl_tpu_torch.serving.client", "ServeClient"),
    "ShedError": ("handyrl_tpu_torch.serving.client", "ShedError"),
    "ServeError": ("handyrl_tpu_torch.serving.client", "ServeError"),
}

__all__ = ["ServingConfig", "RouterConfig", *_LAZY]


def __getattr__(name):
    if name in _LAZY:
        import importlib

        module, attr = _LAZY[name]
        return getattr(importlib.import_module(module), attr)
    raise AttributeError(
        f"module {__name__!r} has no attribute {name!r}")
