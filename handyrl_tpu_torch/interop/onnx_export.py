"""Export the port's torch nets to ``.onnx``.

The counterpart of ``handyrl_tpu.interop.onnx_export``, which walks a
jaxpr.  Here the net's forward runs once, on real tensors and under
``torch.no_grad()``, inside a ``TorchFunctionMode`` that records every
torch call the forward makes: ``F.conv2d``, ``F.group_norm``,
``F.pad``, ``Tensor.permute``, ``torch.cat`` ...  That is the level a
``torch.fx`` trace records, with the concrete shapes of a
``make_fx`` trace.  Neither of those two fits alone: ``make_fx``
lowers ``F.pad(mode="circular")`` to a fresh buffer filled by in-place
``copy_`` calls, which ONNX cannot express, and ``fx.symbolic_trace``
has no shapes, so the fixed-batch graph could not fold them.  Each
recorded call maps to standard ONNX ops:

  * the wrap pad of ``TorusConv`` becomes ``Slice`` + ``Concat`` per
    axis, as ``jnp.pad(mode="wrap")`` does in the JAX file;
  * GroupNorm (opset 17 has no ``GroupNormalization``) becomes
    ``Reshape``/``ReduceMean``/``Sub``/``Mul``/``Sqrt``/``Div`` with the
    module's own epsilon (Flax's 1e-6, not torch's default);
  * a linear layer is ``MatMul`` by its transposed weight, folded to a
    constant, plus ``Add`` of its bias;
  * reshapes and slicing index expressions become ``Slice`` and
    ``Reshape`` to the traced shape.

The table covers the calls the port's nets make (TicTacToeNet,
GeeseNet, GeisterNet, GRFNet).

Parameters become float32 initializers whatever the training dtype;
the recurrent DRC unrolls into plain ops with its hidden state as graph
I/O.  The file is interchangeable with the JAX package's: ir_version 8,
opset 17, inputs ``input_i`` in the observation's leaf order then
``hidden_i`` in the hidden dict's sorted-key order, outputs the output
keys sorted then ``hidden_out_i``, the env's channel-last input shapes,
and only ops both packages' numpy runners execute.  A call the table
does not know raises ``NotImplementedError`` naming it.

Exports are fixed-batch (default 1, the actor-side inference shape).
The model may sit on any device: the graph and the initializers come
out the same, byte for byte.
"""

import numpy as np
import torch
from torch.overrides import TorchFunctionMode

from ..utils.tree import (
    tree_leaves,
    tree_map_leaves,
    tree_structure,
    tree_unflatten,
)
from .onnx_proto import (
    ATTR_FLOAT,
    ATTR_INT,
    ATTR_INTS,
    ATTR_STRING,
    ATTR_TENSOR,
    DT_BOOL,
    DT_FLOAT,
    DT_INT32,
    DT_INT64,
    encode,
)

_NP_TO_DT = {
    np.dtype(np.float32): DT_FLOAT,
    np.dtype(np.int32): DT_INT32,
    np.dtype(np.int64): DT_INT64,
    np.dtype(np.bool_): DT_BOOL,
}


def numpy_to_tensor(arr: np.ndarray, name: str) -> dict:
    arr = np.ascontiguousarray(arr)
    if arr.dtype not in _NP_TO_DT:
        arr = arr.astype(np.float32)
    return {
        "name": name,
        "dims": list(arr.shape),
        "data_type": _NP_TO_DT[arr.dtype],
        "raw_data": arr.tobytes(),
    }


def _attr(name, value):
    if isinstance(value, bool) or isinstance(value, (int, np.integer)):
        return {"name": name, "type": ATTR_INT, "i": int(value)}
    if isinstance(value, float):
        return {"name": name, "type": ATTR_FLOAT, "f": value}
    if isinstance(value, str):
        return {"name": name, "type": ATTR_STRING, "s": value.encode()}
    if isinstance(value, np.ndarray):
        return {"name": name, "type": ATTR_TENSOR,
                "t": numpy_to_tensor(value, name)}
    if isinstance(value, (list, tuple)):
        return {"name": name, "type": ATTR_INTS,
                "ints": [int(v) for v in value]}
    raise TypeError(f"attribute {name}: {type(value)}")


def _value_info(name, shape, elem=DT_FLOAT):
    return {"name": name, "type": {"tensor_type": {
        "elem_type": elem,
        "shape": {"dim": [{"dim_value": int(d)} for d in shape]},
    }}}


def _bind(args, kwargs, names):
    """Positional and keyword arguments of a recorded call, by name."""
    bound = dict(zip(names, args))
    bound.update(kwargs)
    return bound


def _pairs(value, n=2):
    return list(value) if isinstance(value, (list, tuple)) else [value] * n


def _dims(value):
    """``dim`` argument -> a list of ints (``None`` stays None)."""
    if value is None or isinstance(value, (list, tuple)):
        return None if value is None else [int(d) for d in value]
    return [int(value)]


class _Builder:
    """Accumulates nodes and initializers while the forward runs.

    Tensors are known by identity: ``names`` maps ``id(tensor)`` to its
    graph name, and ``keep`` holds every traced tensor so that no id is
    reused while the trace lasts."""

    def __init__(self, params):
        self.nodes = []
        self.initializers = []
        self.counter = 0
        self.names = {}
        self.keep = []
        self.params = {id(p): p for p in params}
        self.folded = {}       # (id(param), transform) -> initializer

    def fresh(self, hint="t"):
        self.counter += 1
        return f"{hint}_{self.counter}"

    def const(self, arr, hint="const"):
        name = self.fresh(hint)
        self.initializers.append(numpy_to_tensor(np.asarray(arr), name))
        return name

    def ints(self, values):
        return self.const(np.asarray(values, np.int64), "shape")

    def node(self, op, inputs, n_out=1, out=None, **attrs):
        outputs = out if out is not None else [
            self.fresh(op.lower()) for _ in range(n_out)]
        self.nodes.append({
            "op_type": op,
            "input": list(inputs),
            "output": list(outputs),
            "attribute": [_attr(k, v) for k, v in attrs.items()
                          if v is not None],
        })
        return outputs[0] if len(outputs) == 1 else outputs

    def bind(self, tensor, name):
        self.names[id(tensor)] = name
        self.keep.append(tensor)

    def param(self, tensor, transform=None):
        """A parameter as a float32 initializer (``transform`` folds a
        layout change into the constant), created once per use kind."""
        key = (id(tensor), transform)
        if key not in self.folded:
            arr = tensor.detach().to("cpu", torch.float32).numpy()
            if transform == "T":
                arr = arr.T
            elif transform is not None:     # a broadcast shape
                arr = arr.reshape(transform)
            self.folded[key] = self.const(arr, "param")
        return self.folded[key]

    def read(self, value):
        """A call argument -> graph name: a traced tensor, a parameter,
        or a Python scalar (a float32 constant)."""
        if isinstance(value, torch.Tensor):
            name = self.names.get(id(value))
            if name is not None:
                return name
            if id(value) in self.params:
                return self.param(value)
            raise NotImplementedError(
                f"a tensor of shape {tuple(value.shape)} entered the "
                f"forward from outside the inputs and the parameters")
        if isinstance(value, (bool, int, float)):
            return self.const(np.float32(value), "scalar")
        raise TypeError(f"cannot read {type(value).__name__} as a tensor")


# -- the emitters, by the recorded call's name --------------------------

def _conv2d(b, args, kwargs, out):
    a = _bind(args, kwargs, ("input", "weight", "bias", "stride",
                             "padding", "dilation", "groups"))
    padding = a.get("padding", 0)
    if isinstance(padding, str):
        raise NotImplementedError(f"conv padding {padding!r}")
    pads = _pairs(padding)
    inputs = [b.read(a["input"]), b.param(a["weight"])]
    if a.get("bias") is not None:
        inputs.append(b.param(a["bias"]))
    return b.node("Conv", inputs, strides=_pairs(a.get("stride", 1)),
                  dilations=_pairs(a.get("dilation", 1)),
                  group=int(a.get("groups", 1)), pads=pads + pads)


def _group_norm(b, args, kwargs, out):
    a = _bind(args, kwargs, ("input", "num_groups", "weight", "bias",
                             "eps"))
    x, groups = a["input"], int(a["num_groups"])
    n, c = x.shape[0], x.shape[1]
    r = b.node("Reshape", [b.read(x), b.ints([n, groups, -1])])
    mean = b.node("ReduceMean", [r], axes=[2], keepdims=1)
    d = b.node("Sub", [r, mean])
    var = b.node("ReduceMean", [b.node("Mul", [d, d])], axes=[2],
                 keepdims=1)
    eps = b.const(np.float32(a.get("eps", 1e-5)), "eps")
    y = b.node("Div", [d, b.node("Sqrt", [b.node("Add", [var, eps])])])
    y = b.node("Reshape", [y, b.ints(list(x.shape))])
    affine = (1, c) + (1,) * (x.dim() - 2)
    if a.get("weight") is not None:
        y = b.node("Mul", [y, b.param(a["weight"], affine)])
    if a.get("bias") is not None:
        y = b.node("Add", [y, b.param(a["bias"], affine)])
    return y


def _pad(b, args, kwargs, out):
    a = _bind(args, kwargs, ("input", "pad", "mode", "value"))
    x, pad = a["input"], [int(p) for p in a["pad"]]
    mode = a.get("mode", "constant")
    name = b.read(x)
    if mode == "constant":
        nd = x.dim()
        lo, hi = [0] * nd, [0] * nd
        for i in range(len(pad) // 2):   # pairs run from the last dim
            lo[nd - 1 - i], hi[nd - 1 - i] = pad[2 * i], pad[2 * i + 1]
        value = a.get("value") or 0.0
        return b.node("Pad", [name, b.ints(lo + hi),
                              b.const(np.float32(value), "pad_value")],
                      mode="constant")
    if mode != "circular":
        raise NotImplementedError(f"F.pad mode {mode!r}")
    for i in range(len(pad) // 2):
        axis = x.dim() - 1 - i
        lo, hi, size = pad[2 * i], pad[2 * i + 1], x.shape[axis]
        if lo > size or hi > size:
            raise NotImplementedError("circular pad wider than its axis")
        parts = []
        if lo:
            parts.append(_slice(b, name, [size - lo], [size], [axis]))
        parts.append(name)
        if hi:
            parts.append(_slice(b, name, [0], [hi], [axis]))
        if len(parts) > 1:
            name = b.node("Concat", parts, axis=axis)
    return name


def _slice(b, name, starts, ends, axes, steps=None):
    return b.node("Slice", [
        name, b.ints(starts), b.ints(ends), b.ints(axes),
        b.ints(steps or [1] * len(starts))])


def _linear(b, args, kwargs, out):
    a = _bind(args, kwargs, ("input", "weight", "bias"))
    y = b.node("MatMul", [b.read(a["input"]), b.param(a["weight"], "T")])
    if a.get("bias") is not None:
        y = b.node("Add", [y, b.param(a["bias"])])
    return y


def _unary(op):
    def emit(b, args, kwargs, out):
        return b.node(op, [b.read(args[0])])
    return emit


def _leaky_relu(b, args, kwargs, out):
    a = _bind(args, kwargs, ("input", "negative_slope", "inplace"))
    if a.get("inplace"):
        raise NotImplementedError("in-place leaky_relu")
    return b.node("LeakyRelu", [b.read(a["input"])],
                  alpha=float(a.get("negative_slope", 0.01)))


def _binary(op):
    def emit(b, args, kwargs, out):
        if kwargs.get("alpha", 1) != 1 or len(args) > 2:
            raise NotImplementedError(f"{op} with alpha")
        other = args[1] if len(args) > 1 else kwargs["other"]
        return b.node(op, [b.read(args[0]), b.read(other)])
    return emit


def _alias(b, args, kwargs, out):
    return b.read(args[0])


def _reshape(b, args, kwargs, out):
    return b.node("Reshape", [b.read(args[0]), b.ints(list(out.shape))])


def _permute(b, args, kwargs, out):
    x = args[0]
    dims = args[1:] if len(args) > 1 else kwargs["dims"]
    if len(dims) == 1 and isinstance(dims[0], (list, tuple)):
        dims = dims[0]
    return b.node("Transpose", [b.read(x)],
                  perm=[int(d) % x.dim() for d in dims])


def _expand(b, args, kwargs, out):
    return b.node("Expand", [b.read(args[0]), b.ints(list(out.shape))])


def _cat(b, args, kwargs, out):
    a = _bind(args, kwargs, ("tensors", "dim"))
    return b.node("Concat", [b.read(t) for t in a["tensors"]],
                  axis=int(a.get("dim", 0)) % out.dim())


def _chunk(b, args, kwargs, out):
    a = _bind(args, kwargs, ("input", "chunks", "dim"))
    axis = int(a.get("dim", 0)) % a["input"].dim()
    sizes = [int(t.shape[axis]) for t in out]
    names = b.node("Split", [b.read(a["input"]), b.ints(sizes)],
                   n_out=len(sizes), axis=axis)
    return names if isinstance(names, list) else [names]


def _reduce(op):
    def emit(b, args, kwargs, out):
        a = _bind(args, kwargs, ("input", "dim", "keepdim"))
        if a.get("dtype") is not None:
            raise NotImplementedError(f"{op} with a dtype")
        x = a["input"]
        axes = _dims(a.get("dim"))
        axes = list(range(x.dim())) if axes is None else [
            d % x.dim() for d in axes]
        keep = int(bool(a.get("keepdim", False)))
        if op == "ReduceSum":   # axes an input since opset 13
            return b.node(op, [b.read(x), b.ints(axes)], keepdims=keep)
        return b.node(op, [b.read(x)], axes=axes, keepdims=keep)
    return emit


def _getitem(b, args, kwargs, out):
    x, index = args[0], args[1]
    if not isinstance(index, tuple):
        index = (index,)
    starts, ends, axes, steps = [], [], [], []
    axis = 0
    for item in index:
        if item is None:
            continue
        if not isinstance(item, slice):
            raise NotImplementedError(f"indexing by {item!r}")
        size = x.shape[axis]
        start, stop, step = item.indices(size)
        if (start, stop, step) != (0, size, 1):
            if step < 1:
                raise NotImplementedError("negative slice steps")
            starts.append(start)
            ends.append(stop)
            axes.append(axis)
            steps.append(step)
        axis += 1
    name = b.read(x)
    if starts:
        name = _slice(b, name, starts, ends, axes, steps)
    return b.node("Reshape", [name, b.ints(list(out.shape))])


_EMITTERS = {
    "conv2d": _conv2d,
    "group_norm": _group_norm,
    "pad": _pad,
    "linear": _linear,
    "relu": _unary("Relu"),
    "tanh": _unary("Tanh"),
    "sigmoid": _unary("Sigmoid"),
    "leaky_relu": _leaky_relu,
    "add": _binary("Add"),
    "mul": _binary("Mul"),
    "contiguous": _alias,
    "reshape": _reshape,
    "permute": _permute,
    "expand": _expand,
    "cat": _cat,
    "chunk": _chunk,
    "mean": _reduce("ReduceMean"),
    "sum": _reduce("ReduceSum"),
    "__getitem__": _getitem,
}


class _Recorder(TorchFunctionMode):
    """Runs each torch call and emits its ONNX ops.  Calls that return
    no tensor (shape and dtype reads) pass through unrecorded; the mode
    is off inside its own handler, so a recorded call's internals are
    not recorded again."""

    def __init__(self, builder):
        super().__init__()
        self.b = builder

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        outs = out if isinstance(out, (tuple, list)) else (out,)
        if not any(isinstance(o, torch.Tensor) for o in outs):
            return out
        name = getattr(func, "__name__", repr(func))
        emitter = _EMITTERS.get(name)
        if emitter is None:
            raise NotImplementedError(
                f"torch call {name!r} ({func!r}) has no ONNX mapping")
        if any(isinstance(o, torch.Tensor) and o.dtype != torch.float32
               for o in outs):
            raise NotImplementedError(
                f"torch call {name!r} returned a non-float32 tensor")
        names = emitter(self.b, args, kwargs, out)
        if isinstance(out, torch.Tensor):
            self.b.bind(out, names)
        else:
            for tensor, tname in zip(out, names):
                self.b.bind(tensor, tname)
        return out


def export_onnx(model, obs_example, path, batch_size=1):
    """Write ``model`` (a ``TorchModel``) to ``path`` as ONNX.

    ``obs_example`` is one unbatched environment observation (it sets
    the input shapes).  A recurrent net's hidden state becomes explicit
    ``hidden_i`` inputs and ``hidden_out_i`` outputs, the discovery
    protocol of :class:`~.onnx_run.OnnxModel`."""
    module = model.module
    device = model.device
    obs_b = tree_map_leaves(
        lambda a: np.broadcast_to(
            np.asarray(a, np.float32), (batch_size,) + np.shape(a)
        ).copy(), obs_example)
    hidden = model.init_hidden([batch_size])

    b = _Builder(list(module.parameters()) + list(module.buffers()))
    obs_leaves = tree_leaves(obs_b)
    hidden_leaves = tree_leaves(hidden)
    input_infos = []

    def upload(leaf, name):
        tensor = torch.from_numpy(np.ascontiguousarray(leaf)).to(device)
        b.bind(tensor, name)
        input_infos.append(_value_info(name, np.shape(leaf)))
        return tensor

    x_leaves = [upload(leaf, f"input_{i}")
                for i, leaf in enumerate(obs_leaves)]
    h_leaves = [upload(leaf, f"hidden_{i}")
                for i, leaf in enumerate(hidden_leaves)]
    x = tree_unflatten(tree_structure(obs_b), x_leaves)
    h = (None if hidden is None
         else tree_unflatten(tree_structure(hidden), h_leaves))

    with torch.no_grad(), _Recorder(b):
        out = dict(module(x, h))
    out_hidden = out.pop("hidden", None)

    outputs = [(key, out[key]) for key in sorted(out)]
    outputs += [(f"hidden_out_{i}", t)
                for i, t in enumerate(tree_leaves(out_hidden))]
    output_infos = []
    for name, tensor in outputs:
        b.node("Identity", [b.read(tensor)], out=[name])
        output_infos.append(_value_info(name, tuple(tensor.shape)))

    graph = {
        "name": "handyrl_tpu_torch",
        "node": b.nodes,
        "initializer": b.initializers,
        "input": input_infos,
        "output": output_infos,
    }
    onnx_model = {
        "ir_version": 8,
        "producer_name": "handyrl-tpu-torch",
        "producer_version": "1.0",
        "opset_import": [{"domain": "", "version": 17}],
        "graph": graph,
    }
    with open(path, "wb") as f:
        f.write(encode(onnx_model, "Model"))
    return path

