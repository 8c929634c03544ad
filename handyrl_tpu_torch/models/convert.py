"""Weights carried across: Flax param trees <-> torch ``state_dict``s.

The JAX package keeps parameters as a nested dict named by Flax's
auto-naming (``TorusConv_0/Conv_0/kernel`` ...), with numpy leaves once
they are on the host (checkpoints, snapshots, ``.npz`` exports).  This
module maps that tree onto the port's modules, name by name:

  * a conv kernel HWIO ``(kh, kw, cin, cout)`` becomes OIHW
    (``transpose(3, 2, 0, 1)``);
  * a Dense kernel ``(in, out)`` becomes ``nn.Linear.weight``
    ``(out, in)``;
  * GroupNorm ``scale``/``bias`` become ``weight``/``bias``, and a conv
    bias stays a vector.

:func:`to_flax` maps back, so the port's checkpoints are the JAX
package's format and both packages read them.  Any missing, left-over
or mis-shaped key raises: a silently skipped
tensor would leave torch's random init in the net and every output
wrong.  :func:`random_flax_params` builds a seeded tree of exactly the
Flax layout with numpy alone, for runs that have no JAX.
"""

import numpy as np
import torch

from ..utils.tree import flatten_params, unflatten_params
from .geese_net import GeeseNet
from .geister_net import GeisterNet
from .grf_net import GRFNet
from .tictactoe_net import TicTacToeNet

CONV, DENSE, VECTOR = "conv", "dense", "vector"


def _norm(flax, torch_name):
    """GroupNorm: Flax ``scale``/``bias`` -> ``weight``/``bias``."""
    return [(f"{flax}/scale", f"{torch_name}.weight", VECTOR),
            (f"{flax}/bias", f"{torch_name}.bias", VECTOR)]


def _conv_norm(flax, torch_prefix):
    """A conv without bias followed by GroupNorm (TorusConv, ConvBlock)."""
    return ([(f"{flax}/Conv_0/kernel", f"{torch_prefix}.conv.weight", CONV)]
            + _norm(f"{flax}/GroupNorm_0", f"{torch_prefix}.norm"))


def _head(flax, torch_prefix):
    """PolicyHead / ValueHead: 1x1 conv with bias, then Dense."""
    return [
        (f"{flax}/Conv_0/kernel", f"{torch_prefix}.conv.weight", CONV),
        (f"{flax}/Conv_0/bias", f"{torch_prefix}.conv.bias", VECTOR),
        (f"{flax}/Dense_0/kernel", f"{torch_prefix}.fc.weight", DENSE),
    ]


def _drc(flax, torch_prefix, drc):
    """DRC: one gate conv (kernel HWIO ``(k, k, cin + C, 4C)``, bias)
    per ConvLSTM cell."""
    entries = []
    for i in range(len(drc.cells)):
        cell = f"{flax}/ConvLSTMCell_{i}/Conv_0"
        entries += [
            (f"{cell}/kernel", f"{torch_prefix}.cells.{i}.conv.weight",
             CONV),
            (f"{cell}/bias", f"{torch_prefix}.cells.{i}.conv.bias",
             VECTOR)]
    return entries


def flax_layout(module):
    """``[(flax_path, torch_name, kind)]`` for every parameter."""
    if isinstance(module, GeeseNet):
        entries = _conv_norm("TorusConv_0", "stem")
        for i in range(len(module.blocks)):
            entries += _conv_norm(f"TorusConv_{i + 1}", f"blocks.{i}")
        entries += [("Dense_0/kernel", "policy.weight", DENSE),
                    ("Dense_1/kernel", "value.weight", DENSE)]
        return entries
    if isinstance(module, TicTacToeNet):
        entries = [("Conv_0/kernel", "stem.weight", CONV),
                   ("Conv_0/bias", "stem.bias", VECTOR)]
        for i in range(len(module.blocks)):
            entries += _conv_norm(f"ConvBlock_{i}", f"blocks.{i}")
        entries += _head("PolicyHead_0", "policy")
        entries += _head("ValueHead_0", "value")
        return entries
    if isinstance(module, GeisterNet):
        entries = [("Conv_0/kernel", "stem.weight", CONV)]
        entries += _norm("GroupNorm_0", "stem_norm")
        entries += _drc("DRC_0", "drc", module.drc)
        entries += [("Conv_1/kernel", "move_conv.weight", CONV)]
        entries += _norm("GroupNorm_1", "move_norm")
        entries += [("Conv_2/kernel", "move_out.weight", CONV),
                    ("Dense_0/kernel", "set_head.weight", DENSE),
                    ("Dense_0/bias", "set_head.bias", VECTOR)]
        entries += _head("ValueHead_0", "value")
        entries += _head("ValueHead_1", "ret")
        return entries
    if isinstance(module, GRFNet):
        entries = []
        for i in range(len(module.stem)):
            entries += [(f"Conv_{i}/kernel", f"stem.{i}.weight", CONV)]
            entries += _norm(f"GroupNorm_{i}", f"stem_norm.{i}")
        entries += _drc("DRC_0", "drc", module.drc)
        entries += _head("PolicyHead_0", "policy")
        entries += _head("ValueHead_0", "value")
        return entries
    raise TypeError(f"no Flax layout known for {type(module).__name__}")


def _to_torch(array, kind):
    a = np.asarray(array, dtype=np.float32)
    if kind == CONV:
        a = a.transpose(3, 2, 0, 1)
    elif kind == DENSE:
        a = a.T
    return torch.from_numpy(np.array(a, dtype=np.float32, order="C"))


def _to_flax_shape(shape, kind):
    if kind == CONV:
        cout, cin, kh, kw = shape
        return (kh, kw, cin, cout)
    if kind == DENSE:
        out, inp = shape
        return (inp, out)
    return tuple(shape)


def torch_axis(kind, flax_axis):
    """The axis of the port's tensor that holds axis ``flax_axis`` of
    the Flax leaf: HWIO -> OIHW for a conv kernel, ``(in, out)`` ->
    ``(out, in)`` for a Dense kernel, the same axis for a vector."""
    if kind == CONV:
        return (2, 3, 1, 0)[flax_axis]
    if kind == DENSE:
        return (1, 0)[flax_axis]
    return flax_axis


def from_flax(params, module):
    """A ``state_dict`` for ``module`` from a Flax param tree (nested
    dict of arrays, as ``module.init(...)["params"]`` of the JAX twin
    returns).  Raises KeyError on a missing or left-over key and
    ValueError on a shape mismatch."""
    flat = flatten_params(params)
    layout = flax_layout(module)
    expected = {path for path, _, _ in layout}
    missing = sorted(expected - set(flat))
    extra = sorted(set(flat) - expected)
    if missing or extra:
        raise KeyError(f"Flax params do not match {type(module).__name__}:"
                       f" missing {missing}, left over {extra}")
    target = module.state_dict()
    state = {}
    for path, name, kind in layout:
        tensor = _to_torch(flat[path], kind)
        if tuple(tensor.shape) != tuple(target[name].shape):
            raise ValueError(
                f"{path}: Flax shape {np.shape(flat[path])} does not "
                f"match {name} {tuple(target[name].shape)}")
        state[name] = tensor
    if set(state) != set(target):
        raise KeyError(f"torch params left unset: "
                       f"{sorted(set(target) - set(state))}")
    return state


def _to_flax_array(tensor, kind):
    a = (tensor.detach().to("cpu", torch.float32, copy=True).numpy()
         if torch.is_tensor(tensor) else np.array(tensor, np.float32))
    if kind == CONV:
        a = a.transpose(2, 3, 1, 0)
    elif kind == DENSE:
        a = a.T
    return np.ascontiguousarray(a)


def state_to_flax(state, module):
    """A Flax-layout numpy tree from a ``{torch_name: tensor}`` mapping
    laid out like ``module``'s parameters (a ``state_dict``, or the
    gradients by parameter name).  Always a copy: the arrays never
    share memory with the tensors they came from."""
    layout = flax_layout(module)
    missing = sorted({name for _, name, _ in layout} - set(state))
    if missing:
        raise KeyError(f"state lacks {missing} of {type(module).__name__}")
    return unflatten_params({path: _to_flax_array(state[name], kind)
                             for path, name, kind in layout})


def to_flax(module):
    """The inverse of :func:`from_flax`: ``module``'s parameters as the
    JAX package's Flax-named numpy tree, the format of its checkpoints
    (``{"params": tree, ...}``)."""
    return state_to_flax(module.state_dict(), module)


def random_flax_params(module, seed=0):
    """A seeded Flax-layout param tree for ``module``, numpy only.

    Kernels draw Flax's default ``lecun_normal`` (a normal of variance
    1/fan_in truncated at two standard deviations); GroupNorm scales
    draw around 1 and every bias around 0, so a swapped scale/bias or
    a transposed kernel changes the outputs."""
    rng = np.random.default_rng(seed)
    shapes = {name: tuple(t.shape) for name, t in module.state_dict().items()}
    flat = {}
    for path, name, kind in flax_layout(module):
        shape = _to_flax_shape(shapes[name], kind)
        if kind == VECTOR:
            base = 1.0 if path.endswith("/scale") else 0.0
            value = base + 0.1 * rng.standard_normal(shape)
        else:
            fan_in = int(np.prod(shape[:-1]))
            std = np.sqrt(1.0 / fan_in) / 0.87962566103423978
            z = rng.standard_normal(shape)
            out = np.abs(z) > 2.0
            while out.any():  # truncate by redrawing, as Flax does
                z[out] = rng.standard_normal(int(out.sum()))
                out = np.abs(z) > 2.0
            value = std * z
        flat[path] = value.astype(np.float32)
    return unflatten_params(flat)
