"""The training step: forward, backward, clip, Adam.

The counterpart of ``handyrl_tpu.ops.update``.  The JAX package
compiles ``update_step(params, opt_state, batch)`` into one XLA program
and donates its state; here the step is an eager PyTorch sequence that
updates the module's parameters and the optimizer state in place:

  loss + ``backward()`` -> global-norm clip 4.0 -> L2 1e-5 added to the
  clipped gradient -> Adam (b1 0.9, b2 0.999, eps 1e-8 outside the
  sqrt) -> scaled by the learning rate.

That is the optax chain ``clip_by_global_norm(4.0) ->
add_decayed_weights(1e-5) -> scale_by_adam() -> scale_by_learning_rate``
term for term: ``torch.optim.Adam(weight_decay=...)`` adds the L2 term
to the (already clipped) gradient before its moments, and its
``lr * m_hat / (sqrt(v_hat) + eps)`` is optax's.  The clip is written
out rather than ``clip_grad_norm_``, which divides by ``norm + 1e-6``;
optax scales by ``4.0 / norm`` only where ``norm >= 4.0``.  The norm is
computed on the device and never read back, so a step does no
host-device synchronisation.

The learning rate is ``3e-8 * data_count_ema / (1 + steps * 1e-5)``,
set on the optimizer's ``param_groups`` between epochs.

Over a rank mesh, :mod:`..parallel.update` subclasses the step: its
``loss_and_grads`` sums the gradients and metrics over the ranks
between backward and clip, its ``grad_norm`` is the global norm of
sharded gradients, and the clip and the target refresh act on each
DTensor's local part (``local_tensor``).
"""

import numpy as np
import torch

from ..utils.tree import tree_leaves, tree_map_leaves
from .losses import LossConfig, compute_loss

DEFAULT_LR = 3e-8
GRAD_CLIP_NORM = 4.0
WEIGHT_DECAY = 1e-5


def local_tensor(t):
    """This rank's part of a DTensor (sharded parameters and their
    gradients, :mod:`..parallel.update`); any other tensor as is."""
    return t.to_local() if hasattr(t, "to_local") else t


def make_optimizer(params, learning_rate):
    """Adam with the optax chain's L2 term and epsilon.  On the card
    the fused implementation updates every tensor in one launch.
    Sharded (DTensor) parameters get a param group of their own: a
    multi-tensor kernel takes DTensors or plain tensors, not both."""
    params = list(params)
    fused = bool(params) and local_tensor(params[0]).device.type == "cuda"
    sharded = [p for p in params if hasattr(p, "to_local")]
    if sharded:
        plain = [p for p in params if not hasattr(p, "to_local")]
        params = [{"params": g} for g in (plain, sharded) if g]
    return torch.optim.Adam(params, lr=learning_rate, betas=(0.9, 0.999),
                            eps=1e-8, weight_decay=WEIGHT_DECAY,
                            fused=fused or None)


def set_learning_rate(optimizer, lr):
    """Anneal the learning rate between epochs."""
    for group in optimizer.param_groups:
        group["lr"] = float(lr)


def make_apply_fn(module, compute_dtype="float32"):
    """The net's forward for the update step: ``(obs, hidden) ->
    outputs``, observations and hidden as trees of ``(N, ...)``
    tensors (``hidden`` None for a feed-forward net).

    With ``compute_dtype: bfloat16`` only the forward runs in low
    precision: it runs under ``torch.autocast`` (convolutions and
    matmuls in bf16; autocast keeps GroupNorm, softmax and reductions
    in float32), the parameters stay float32, and every output comes
    back as float32, so the loss math and the Adam state keep full
    precision.  As in the JAX step, the observations and the hidden
    state are cast to bf16 on the way in and every output, the new
    hidden included, back to float32 on the way out: a recurrent
    net's carry is float32 between steps, and inside a step its
    ConvLSTM gates (the conv's output, the sigmoids and tanhs and the
    cell update) run in bf16."""
    low = str(compute_dtype) == "bfloat16"
    if not low and str(compute_dtype) != "float32":
        raise ValueError(f"unknown compute_dtype {compute_dtype!r}")
    dtype = torch.bfloat16 if low else torch.float32

    def cast(tree):
        return tree_map_leaves(lambda a: a.to(dtype), tree)

    def apply_fn(obs, hidden=None):
        device_type = tree_leaves(obs)[0].device.type
        with torch.autocast(device_type, dtype=torch.bfloat16,
                            enabled=low):
            out = module(cast(obs), cast(hidden))
        return {k: tree_map_leaves(lambda v: v.float(), v)
                for k, v in out.items() if v is not None}

    return apply_fn


@torch.no_grad()
def refresh_target(module, target_module, count, cfg: LossConfig):
    """Refresh the IMPACT target network in place after optimizer step
    ``count`` (1-based): Polyak averaging when ``target_update_tau > 0``,
    else a hard copy every ``target_update_interval`` steps; with
    neither the target stays frozen."""
    params = [local_tensor(p) for p in module.parameters()]
    target = [local_tensor(p) for p in target_module.parameters()]
    if cfg.target_update_tau > 0.0:
        torch._foreach_add_(target, torch._foreach_sub(params, target),
                            alpha=cfg.target_update_tau)
    elif (cfg.target_update_interval > 0
            and count % cfg.target_update_interval == 0):
        torch._foreach_copy_(target, params)


class UpdateStep:
    """One optimizer step on a batch: ``step(batch) -> metrics``.

    ``metrics`` holds 0-dim device tensors (the loss components,
    ``dcnt``, ``clip_frac``, ``grad_norm`` before the clip, and
    ``nonfinite``: 1.0 when the loss or the gradient norm is NaN/Inf).
    As in the JAX step, a nonfinite step is not skipped.  Under
    ``update_algorithm: impact`` the target module refreshes in place
    after each step; ``count`` is the optimizer step count it keys on
    (the trainer restores it on resume)."""

    def __init__(self, module, cfg: LossConfig, optimizer,
                 compute_dtype="float32", target_module=None):
        self.module = module
        self.cfg = cfg
        self.optimizer = optimizer
        self.params = [p for p in module.parameters() if p.requires_grad]
        self.apply_fn = make_apply_fn(module, compute_dtype)
        self.target_module = target_module
        self.target_apply_fn = (
            None if target_module is None
            else make_apply_fn(target_module, compute_dtype))
        self.count = 0

    def init_hidden(self, batch):
        """A recurrent net's zero ``(B, P, ...)`` state for ``batch``,
        built on the batch's device; None for a feed-forward net."""
        if not hasattr(self.module, "init_hidden"):
            return None
        value = batch["value"]  # (B, T, P, 1)
        return self.module.init_hidden((value.shape[0], value.shape[2]),
                                       device=value.device)

    def loss_and_grads(self, batch):
        """Forward + backward; the gradients land in ``param.grad``."""
        self.optimizer.zero_grad(set_to_none=True)
        losses, dcnt = compute_loss(self.apply_fn, batch,
                                    self.init_hidden(batch), self.cfg,
                                    target_apply_fn=self.target_apply_fn)
        losses["total"].backward()
        return losses, dcnt

    def grad_norm(self, grads):
        """The global norm of ``grads``, computed on the device."""
        return torch.linalg.vector_norm(
            torch.stack(torch._foreach_norm(grads)))

    def apply_grads(self):
        """Clip the gradients in ``param.grad``, step Adam, refresh the
        target network; returns the gradient norm before the clip."""
        grads = [p.grad for p in self.params if p.grad is not None]
        gnorm = self.grad_norm(grads)
        scale = torch.where(gnorm < GRAD_CLIP_NORM,
                            torch.ones_like(gnorm), GRAD_CLIP_NORM / gnorm)
        torch._foreach_mul_([local_tensor(g) for g in grads], scale)
        self.optimizer.step()
        self.count += 1
        if self.target_module is not None:
            refresh_target(self.module, self.target_module, self.count,
                           self.cfg)
        return gnorm

    def optimizer_state(self):
        """The Adam state as ``optimizer.state_dict()`` (the format of
        ``train_state.ckpt``)."""
        return self.optimizer.state_dict()

    def load_optimizer_state(self, opt_state):
        """Restore :meth:`optimizer_state`'s format (host arrays): the
        saved hyper-parameters with this run's choice of implementation
        (fused on the card, foreach on the CPU)."""
        impl = ("fused", "foreach", "capturable", "differentiable")
        groups = [dict(saved, **{k: now[k] for k in impl if k in now})
                  for saved, now in zip(opt_state["param_groups"],
                                        self.optimizer.param_groups)]
        self.optimizer.load_state_dict({
            "state": {int(i): {k: torch.from_numpy(np.asarray(v))
                               for k, v in s.items()}
                      for i, s in opt_state["state"].items()},
            "param_groups": groups})

    def __call__(self, batch):
        losses, dcnt = self.loss_and_grads(batch)
        gnorm = self.apply_grads()
        finite = torch.isfinite(losses["total"]) & torch.isfinite(gnorm)
        metrics = {k: v.detach() for k, v in losses.items()}
        metrics.update(dcnt=dcnt.detach(), grad_norm=gnorm.detach(),
                       nonfinite=1.0 - finite.float())
        return metrics
