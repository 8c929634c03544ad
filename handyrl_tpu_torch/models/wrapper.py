"""Model wrapper: one numpy-in, numpy-out surface over the torch nets.

The counterpart of ``handyrl_tpu.models.wrapper``: the same duck
surface as ``TPUModel`` — ``inference`` (one state, no batch dim) and
``inference_batch`` (``(N, ...)`` leaves), numpy in and numpy out with
the envs' channel-last observations, plus ``init_hidden`` and
``is_recurrent`` — so agents, the rollout engines and the inference
service drive either package's model unchanged.

Parameters live in the ``nn.Module`` on ``device`` (``"cuda"`` unless
the caller names another; see :mod:`..device`).  A forward uploads the
observation batch once, runs under ``torch.inference_mode()`` and
downloads every output in ONE device-to-host copy.

Pickling ships ``(module class, constructor config, numpy params)``,
never tensors: an unpickled model is rebuilt on the CPU, and a process
that wants it elsewhere asks with :meth:`TorchModel.to`.  A spawned
child therefore never touches its parent's CUDA context.
"""

import pickle
from typing import Any, Dict

import numpy as np
import torch

from ..device import DEFAULT_DEVICE, resolve_device
from ..utils.tree import (
    tree_flatten,
    tree_leaves,
    tree_map_leaves,
    tree_unflatten,
)
from .convert import from_flax, random_flax_params


def _numpy_state(state):
    return {k: (v.detach().cpu().numpy() if torch.is_tensor(v)
                else np.asarray(v)) for k, v in state.items()}


def snapshot_params(params) -> bytes:
    """Serialize a ``state_dict`` (tensors or arrays) as pickled numpy."""
    return pickle.dumps(_numpy_state(params))


def load_params(blob: bytes):
    return pickle.loads(blob)


def build_module(spec, device):
    """Instantiate ``spec = (cls, config)`` with uninitialized storage
    on ``device`` (no RNG draw, no throwaway init); the caller loads
    the parameters."""
    cls, config = spec
    with torch.device("meta"):
        module = cls(**config)
    return module.to_empty(device=device).eval()


class TorchModel:
    """A torch net bound to its parameters on one device."""

    def __init__(self, module, params=None, device=DEFAULT_DEVICE):
        self.device = resolve_device(device)
        self.module = module.to(self.device).eval()
        if params is not None:
            self.load_params(params)

    @classmethod
    def from_flax(cls, module, flax_params, device=DEFAULT_DEVICE):
        """Bind ``module`` to a Flax param tree of its JAX twin."""
        return cls(module, from_flax(flax_params, module), device=device)

    # -- parameters ---------------------------------------------------
    def init_params(self, example_obs=None, seed: int = 0):
        """Seeded parameters (numpy draws, the Flax init's layout and
        distributions), so the same seed gives the same net on any
        device.  ``example_obs`` is accepted for ``TPUModel`` parity;
        the torch modules know their input width."""
        self.load_params(from_flax(random_flax_params(self.module, seed),
                                   self.module))
        return self.params

    @property
    def spec(self):
        return type(self.module), dict(self.module.config)

    @property
    def params(self) -> Dict[str, np.ndarray]:
        """Host copy of the ``state_dict`` as numpy arrays."""
        return _numpy_state(self.module.state_dict())

    def load_params(self, state):
        """Copy a ``state_dict`` (tensors or arrays) into the module's
        device tensors; a missing or unexpected key raises."""
        self.module.load_state_dict(
            {k: torch.as_tensor(np.asarray(v)) if not torch.is_tensor(v)
             else v for k, v in state.items()})

    def to(self, device):
        self.device = resolve_device(device)
        self.module.to(self.device)
        return self

    def init_hidden(self, batch_shape=None):
        """Zero hidden state as float32 numpy leaves with leading
        ``batch_shape`` dims (``None``/``[]``: no batch dim), or None
        for feed-forward nets."""
        if not self.is_recurrent:
            return None
        hidden = self.module.init_hidden(tuple(batch_shape or ()),
                                         device="cpu")
        return tree_map_leaves(lambda t: t.numpy(), hidden)

    @property
    def is_recurrent(self) -> bool:
        return hasattr(self.module, "init_hidden")

    # -- forward ------------------------------------------------------
    def forward_numpy(self, obs, hidden=None) -> Dict[str, np.ndarray]:
        """Batched forward: numpy leaves in, numpy dict out (a
        recurrent net's new state under ``"hidden"``, float32)."""
        return forward_numpy(self.module, self.device, obs, hidden)

    def inference(self, obs, hidden=None) -> Dict[str, Any]:
        """Single-state forward: numpy in, numpy out (no batch dim)."""
        obs_b = tree_map_leaves(lambda a: np.asarray(a)[None], obs)
        hidden_b = (None if hidden is None else
                    tree_map_leaves(lambda a: np.asarray(a)[None], hidden))
        out = self.forward_numpy(obs_b, hidden_b)
        return tree_map_leaves(lambda a: a[0], out)

    def inference_batch(self, obs, hidden=None) -> Dict[str, Any]:
        """Batched actor forward: numpy ``(N, ...)`` leaves in and out."""
        return self.forward_numpy(obs, hidden)

    # -- serialization (process shipping) ------------------------------
    def __getstate__(self):
        return {"spec": self.spec, "params": self.params}

    def __setstate__(self, state):
        self.device = torch.device("cpu")
        self.module = build_module(state["spec"], self.device)
        self.load_params(state["params"])


def forward_numpy(module, device, obs, hidden=None):
    """``module`` on numpy ``(N, ...)`` leaves, under
    ``torch.inference_mode()``: one host-to-device copy per input leaf,
    one device-to-host copy for all outputs together, no other
    synchronisation."""
    def upload(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    with torch.inference_mode():
        x = tree_map_leaves(upload, obs)
        h = None if hidden is None else tree_map_leaves(upload, hidden)
        return _download(module(x, h))


def _download(out):
    """Move a tree of ``(N, ...)`` device tensors (the heads, and a
    recurrent net's hidden dict) to numpy with one device-to-host copy
    (float32 leaves packed side by side)."""
    tensors, treedef = tree_flatten(out)
    if any(t.dtype != torch.float32 for t in tensors):
        return tree_map_leaves(lambda t: t.cpu().numpy(), out)
    n = tensors[0].shape[0]
    flat = torch.cat([t.reshape(n, -1) for t in tensors], dim=1)
    host = flat.cpu().numpy()
    leaves, lo = [], 0
    for t in tensors:
        width = int(np.prod(t.shape[1:], dtype=np.int64))
        leaves.append(np.ascontiguousarray(
            host[:, lo:lo + width]).reshape(t.shape))
        lo += width
    return tree_unflatten(treedef, leaves)


class RandomModel:
    """Uniform-policy stand-in: zero logits over every head, built from
    a real model's output structure on a sample observation."""

    def __init__(self, model, example_obs):
        outputs = model.inference(example_obs, model.init_hidden())
        self._outputs = {
            k: np.zeros_like(v)
            for k, v in outputs.items()
            if k != "hidden"
        }

    def init_hidden(self, batch_shape=None):
        return None

    def inference(self, obs=None, hidden=None):
        return dict(self._outputs)

    def inference_batch(self, obs, hidden=None):
        """Zero logits for every row of the batch (uniform policy)."""
        n = tree_leaves(obs)[0].shape[0]
        return {
            k: np.broadcast_to(v, (n,) + v.shape)
            for k, v in self._outputs.items()
        }
