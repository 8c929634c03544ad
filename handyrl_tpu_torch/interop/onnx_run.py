"""Run ``.onnx`` policy networks with numpy — no onnxruntime needed.

A copy of ``handyrl_tpu.interop.onnx_run``: ``--eval`` accepts a
``.onnx`` artifact, hidden states are discovered by the ``hidden``
input-name prefix, and inference is numpy -> numpy with the agents'
output contract ({name: array, "hidden": [arrays] | None}).  Only the
leaf order of an observation tree comes from :mod:`..utils.tree`
(jax's order) instead of ``jax.tree``.

The interpreter executes the graph nodes in order (ONNX graphs are
topologically sorted by spec) over a numpy environment.  The op set
covers what policy-value networks use: conv/matmul stacks, elementwise
activations, normalization, pooling, shaping — the port's own exports
(onnx_export.py), the JAX package's, and typical torch-exported nets.
Actor-side evaluation is latency-bound at batch 1, where numpy is
plenty.  It runs on the host: a file is the same whatever device it
was exported from.
"""

import numpy as np

from .onnx_proto import (
    DT_BOOL,
    DT_DOUBLE,
    DT_FLOAT,
    DT_FLOAT16,
    DT_INT32,
    DT_INT64,
    DT_INT8,
    DT_UINT8,
    decode,
)
from ..utils.tree import tree_leaves

_DTYPES = {
    DT_FLOAT: np.float32, DT_UINT8: np.uint8, DT_INT8: np.int8,
    DT_INT32: np.int32, DT_INT64: np.int64, DT_BOOL: np.bool_,
    DT_FLOAT16: np.float16, DT_DOUBLE: np.float64,
}


def tensor_to_numpy(t: dict) -> np.ndarray:
    code = t.get("data_type", DT_FLOAT)
    dtype = _DTYPES.get(code)
    if dtype is None:
        try:  # bfloat16, where the ml_dtypes package is installed
            import ml_dtypes

            dtype = {16: np.dtype(ml_dtypes.bfloat16)}[code]
        except Exception:
            raise NotImplementedError(
                f"ONNX tensor data_type {code} is not supported")
    dims = [int(d) for d in t.get("dims", [])]
    raw = t.get("raw_data")
    if raw:
        arr = np.frombuffer(raw, dtype=dtype)
    elif t.get("float_data"):
        arr = np.asarray(t["float_data"], np.float32).astype(dtype)
    elif t.get("int64_data"):
        arr = np.asarray(t["int64_data"], np.int64).astype(dtype)
    elif t.get("int32_data"):
        arr = np.asarray(t["int32_data"], np.int32).astype(dtype)
    else:
        arr = np.zeros(0, dtype)
    return arr.reshape(dims).copy()


def _attrs(node):
    out = {}
    for a in node.get("attribute", []):
        name = a["name"]
        if a.get("t") is not None:
            out[name] = tensor_to_numpy(a["t"])
        elif a.get("ints"):
            out[name] = [int(v) for v in a["ints"]]
        elif a.get("floats"):
            out[name] = [float(v) for v in a["floats"]]
        elif a.get("s") is not None and a.get("s") != b"":
            out[name] = a["s"].decode()
        elif a.get("f") is not None:
            out[name] = float(a["f"])
        elif a.get("i") is not None:
            out[name] = int(a["i"])
        else:
            # presence with all-default payload: treat as 0/empty int
            out[name] = int(a.get("i") or 0)
    return out


def _conv(x, w, b, attrs):
    """Grouped 2D convolution, NCHW, via im2col matmul."""
    group = int(attrs.get("group", 1))
    strides = attrs.get("strides", [1, 1])
    dilations = attrs.get("dilations", [1, 1])
    auto_pad = attrs.get("auto_pad", "NOTSET")
    if auto_pad in ("SAME_UPPER", "SAME_LOWER"):
        pads = [0, 0, 0, 0]
        for i, (size, kern) in enumerate(zip(x.shape[2:],
                                             w.shape[2:])):
            eff = (kern - 1) * dilations[i] + 1
            out_sz = -(-size // strides[i])  # ceil
            total = max((out_sz - 1) * strides[i] + eff - size, 0)
            lo = total // 2 if auto_pad == "SAME_UPPER" \
                else total - total // 2
            pads[i], pads[i + 2] = lo, total - lo
    elif auto_pad not in ("NOTSET", "VALID"):
        raise NotImplementedError(f"Conv auto_pad={auto_pad}")
    else:
        pads = attrs.get("pads", [0, 0, 0, 0])  # t, l, b, r
    N, C, H, W = x.shape
    M, Cg, KH, KW = w.shape
    x = np.pad(x, ((0, 0), (0, 0), (pads[0], pads[2]),
                   (pads[1], pads[3])))
    H_out = (x.shape[2] - (KH - 1) * dilations[0] - 1) // strides[0] + 1
    W_out = (x.shape[3] - (KW - 1) * dilations[1] - 1) // strides[1] + 1
    # im2col: (N, C, KH, KW, H_out, W_out)
    s = x.strides
    cols = np.lib.stride_tricks.as_strided(
        x,
        (N, C, KH, KW, H_out, W_out),
        (s[0], s[1], s[2] * dilations[0], s[3] * dilations[1],
         s[2] * strides[0], s[3] * strides[1]),
        writeable=False,
    )
    out = np.empty((N, M, H_out, W_out), np.float32)
    per_g_in, per_g_out = C // group, M // group
    for g in range(group):
        cg = cols[:, g * per_g_in:(g + 1) * per_g_in]
        wg = w[g * per_g_out:(g + 1) * per_g_out]
        # (N, HW, C*KH*KW) @ (C*KH*KW, M_g)
        lhs = cg.transpose(0, 4, 5, 1, 2, 3).reshape(
            N * H_out * W_out, -1)
        res = lhs @ wg.reshape(per_g_out, -1).T
        out[:, g * per_g_out:(g + 1) * per_g_out] = res.reshape(
            N, H_out, W_out, per_g_out).transpose(0, 3, 1, 2)
    if b is not None:
        out += b.reshape(1, -1, 1, 1)
    return out


def _pool(x, attrs, reducer, is_avg):
    if attrs.get("ceil_mode"):
        raise NotImplementedError("pooling with ceil_mode=1")
    k = attrs["kernel_shape"]
    strides = attrs.get("strides", [1] * len(k))  # ONNX default: 1
    pads = attrs.get("pads", [0] * 4)
    fill = 0.0 if is_avg else -np.inf
    x = np.pad(x, ((0, 0), (0, 0), (pads[0], pads[2]),
                   (pads[1], pads[3])), constant_values=fill)
    N, C, H, W = x.shape
    H_out = (H - k[0]) // strides[0] + 1
    W_out = (W - k[1]) // strides[1] + 1
    s = x.strides
    win = np.lib.stride_tricks.as_strided(
        x, (N, C, H_out, W_out, k[0], k[1]),
        (s[0], s[1], s[2] * strides[0], s[3] * strides[1], s[2], s[3]),
        writeable=False)
    out = reducer(win, axis=(4, 5))
    if is_avg and any(pads) and not attrs.get("count_include_pad"):
        # ONNX default excludes padding from the mean: rescale by the
        # (kernel area) / (valid elements) per output position
        ones = np.ones((1, 1) + (H - pads[0] - pads[2],
                                 W - pads[1] - pads[3]), x.dtype)
        ones = np.pad(ones, ((0, 0), (0, 0), (pads[0], pads[2]),
                             (pads[1], pads[3])))
        so = ones.strides
        counts = np.lib.stride_tricks.as_strided(
            ones, (1, 1, H_out, W_out, k[0], k[1]),
            (so[0], so[1], so[2] * strides[0], so[3] * strides[1],
             so[2], so[3]), writeable=False).sum(axis=(4, 5))
        out = out * (k[0] * k[1]) / counts
    return out


class _Runner:
    """One graph execution pass."""

    def __init__(self, nodes, env):
        self.env = env
        self.nodes = nodes

    def run(self, outputs):
        for node in self.nodes:
            self._exec(node)
        return [self.env[name] for name in outputs]

    def _in(self, node, i, default=None):
        names = node.get("input", [])
        if i >= len(names) or not names[i]:
            return default
        return self.env[names[i]]

    def _axes(self, attrs, node, idx=1):
        """axes as an attribute (opset <13) or an input (opset >=13)."""
        if "axes" in attrs:
            return tuple(attrs["axes"])
        axes_in = self._in(node, idx)
        if axes_in is not None:
            return tuple(int(v) for v in axes_in)
        return None

    def _exec(self, node):
        op = node["op_type"]
        attrs = _attrs(node)
        env = self.env
        x = self._in(node, 0)
        out_names = node["output"]

        if op == "Conv":
            r = _conv(np.asarray(x, np.float32),
                      np.asarray(self._in(node, 1), np.float32),
                      self._in(node, 2), attrs)
        elif op in ("MatMul",):
            r = np.matmul(x, self._in(node, 1))
        elif op == "Gemm":
            a, b = x, self._in(node, 1)
            if attrs.get("transA"):
                a = a.T
            if attrs.get("transB"):
                b = b.T
            r = attrs.get("alpha", 1.0) * (a @ b)
            c = self._in(node, 2)
            if c is not None:
                r = r + attrs.get("beta", 1.0) * c
        elif op == "Add":
            r = x + self._in(node, 1)
        elif op == "Sub":
            r = x - self._in(node, 1)
        elif op == "Mul":
            r = x * self._in(node, 1)
        elif op == "Div":
            r = x / self._in(node, 1)
        elif op == "Pow":
            r = np.power(x, self._in(node, 1))
        elif op == "Max":
            r = x
            for i in range(1, len(node["input"])):
                r = np.maximum(r, self._in(node, i))
        elif op == "Min":
            r = x
            for i in range(1, len(node["input"])):
                r = np.minimum(r, self._in(node, i))
        elif op == "Neg":
            r = -x
        elif op == "Abs":
            r = np.abs(x)
        elif op == "Exp":
            r = np.exp(x)
        elif op == "Log":
            r = np.log(x)
        elif op == "Sqrt":
            r = np.sqrt(x)
        elif op == "Reciprocal":
            r = 1.0 / x
        elif op == "Relu":
            r = np.maximum(x, 0)
        elif op == "LeakyRelu":
            alpha = attrs.get("alpha", 0.01)
            r = np.where(x >= 0, x, alpha * x)
        elif op == "Tanh":
            r = np.tanh(x)
        elif op == "Sigmoid":
            r = 1.0 / (1.0 + np.exp(-x))
        elif op == "Softmax":
            axis = attrs.get("axis", -1)
            e = np.exp(x - np.max(x, axis=axis, keepdims=True))
            r = e / e.sum(axis=axis, keepdims=True)
        elif op in ("GreaterOrEqual", "Greater", "LessOrEqual",
                    "Less", "Equal", "And", "Or", "Xor"):
            y = self._in(node, 1)
            r = {"GreaterOrEqual": np.greater_equal,
                 "Greater": np.greater,
                 "LessOrEqual": np.less_equal, "Less": np.less,
                 "Equal": np.equal, "And": np.logical_and,
                 "Or": np.logical_or, "Xor": np.logical_xor}[op](x, y)
        elif op == "Not":
            r = np.logical_not(x)
        elif op == "IsNaN":
            r = np.isnan(x)
        elif op == "IsInf":
            r = np.isinf(x)
        elif op == "Floor":
            r = np.floor(x)
        elif op == "Where":
            r = np.where(x, self._in(node, 1), self._in(node, 2))
        elif op in ("Identity", "Dropout"):
            r = x
        elif op == "Cast":
            r = np.asarray(x).astype(_DTYPES[attrs["to"]])
        elif op == "Constant":
            r = attrs["value"]
        elif op == "ConstantOfShape":
            value = attrs.get("value")
            fill = value.reshape(-1)[0] if value is not None else 0.0
            r = np.full([int(v) for v in x], fill,
                        value.dtype if value is not None else np.float32)
        elif op == "Shape":
            r = np.asarray(np.shape(x), np.int64)
        elif op == "Reshape":
            shape = [int(v) for v in self._in(node, 1)]
            shape = [x.shape[i] if v == 0 else v
                     for i, v in enumerate(shape)]
            r = np.reshape(x, shape)
        elif op == "Flatten":
            axis = attrs.get("axis", 1)
            lead = int(np.prod(x.shape[:axis])) if axis else 1
            r = np.reshape(x, (lead, -1))
        elif op == "Transpose":
            r = np.transpose(x, attrs.get("perm"))
        elif op == "Concat":
            parts = [self._in(node, i)
                     for i in range(len(node["input"]))]
            r = np.concatenate(parts, axis=attrs["axis"])
        elif op == "Split":
            axis = attrs.get("axis", 0)
            if "split" in attrs:
                sizes = attrs["split"]
            elif len(node.get("input", [])) > 1:
                sizes = [int(v) for v in self._in(node, 1)]
            else:
                sizes = [x.shape[axis] // len(out_names)] * len(out_names)
            pieces = np.split(x, np.cumsum(sizes)[:-1], axis=axis)
            for name, piece in zip(out_names, pieces):
                env[name] = piece
            return
        elif op == "Slice":
            if "starts" in attrs:  # opset <= 9 attribute form
                starts, ends = attrs["starts"], attrs["ends"]
                axes = attrs.get("axes",
                                 list(range(len(starts))))
                steps = [1] * len(starts)
            else:
                starts = [int(v) for v in self._in(node, 1)]
                ends = [int(v) for v in self._in(node, 2)]
                axes = ([int(v) for v in self._in(node, 3)]
                        if self._in(node, 3) is not None
                        else list(range(len(starts))))
                steps = ([int(v) for v in self._in(node, 4)]
                         if self._in(node, 4) is not None
                         else [1] * len(starts))
            idx = [slice(None)] * x.ndim
            for st, en, ax, sp in zip(starts, ends, axes, steps):
                idx[ax] = slice(st, en, sp)
            r = x[tuple(idx)]
        elif op == "Gather":
            r = np.take(x, np.asarray(self._in(node, 1), np.int64),
                        axis=attrs.get("axis", 0))
        elif op == "Expand":
            r = np.broadcast_to(
                x, np.broadcast_shapes(
                    x.shape, tuple(int(v) for v in self._in(node, 1))))
        elif op in ("Squeeze", "Unsqueeze"):
            axes = self._axes(attrs, node)
            if op == "Squeeze":
                r = np.squeeze(x, axis=axes)
            else:
                r = x
                for ax in sorted(axes):
                    r = np.expand_dims(r, ax)
        elif op in ("ReduceSum", "ReduceMean", "ReduceMax", "ReduceMin"):
            axes = self._axes(attrs, node)
            keep = bool(attrs.get("keepdims", 1))
            fn = {"ReduceSum": np.sum, "ReduceMean": np.mean,
                  "ReduceMax": np.max, "ReduceMin": np.min}[op]
            r = fn(x, axis=axes, keepdims=keep)
        elif op == "GlobalAveragePool":
            r = x.mean(axis=tuple(range(2, x.ndim)), keepdims=True)
        elif op == "MaxPool":
            r = _pool(x, attrs, np.max, is_avg=False)
        elif op == "AveragePool":
            r = _pool(x, attrs, np.mean, is_avg=True)
        elif op == "BatchNormalization":
            scale, b = self._in(node, 1), self._in(node, 2)
            mean, var = self._in(node, 3), self._in(node, 4)
            eps = attrs.get("epsilon", 1e-5)
            shape = (1, -1) + (1,) * (x.ndim - 2)
            r = (x - mean.reshape(shape)) / np.sqrt(
                var.reshape(shape) + eps)
            r = r * scale.reshape(shape) + b.reshape(shape)
        elif op == "Pad":
            mode = attrs.get("mode", "constant")
            if "pads" in attrs:
                pads = attrs["pads"]
                value = attrs.get("value", 0.0)
            else:
                pads = [int(v) for v in self._in(node, 1)]
                cval = self._in(node, 2)
                value = float(np.reshape(cval, -1)[0]) \
                    if cval is not None else 0.0
            n = x.ndim
            width = [(pads[i], pads[i + n]) for i in range(n)]
            np_mode = {"constant": "constant", "reflect": "reflect",
                       "edge": "edge", "wrap": "wrap"}[mode]
            kwargs = {"constant_values": value} \
                if np_mode == "constant" else {}
            r = np.pad(x, width, mode=np_mode, **kwargs)
        else:
            raise NotImplementedError(
                f"ONNX op {op!r} is not supported by the numpy runner")
        env[out_names[0]] = r


class OnnxModel:
    """Drop-in for the evaluation model slot: ``--eval model.onnx``.

    Mirrors the reference OnnxModel contract: hidden states are the
    graph inputs whose names start with ``hidden``; inference maps the
    observation pytree leaves onto the remaining inputs in order.
    """

    def __init__(self, model_path):
        self.model_path = model_path
        self._graph = None

    def _load(self):
        with open(self.model_path, "rb") as f:
            model = decode(f.read(), "Model")
        g = model["graph"]
        self._graph = g
        self._init = {t["name"]: tensor_to_numpy(t)
                      for t in g.get("initializer", [])}
        self._inputs = [vi for vi in g.get("input", [])
                        if vi["name"] not in self._init]
        self._outputs = [vi["name"] for vi in g.get("output", [])]
        self._hidden_inputs = [vi for vi in self._inputs
                               if vi["name"].startswith("hidden")]
        self._data_inputs = [vi for vi in self._inputs
                             if not vi["name"].startswith("hidden")]

    @staticmethod
    def _vi_shape(vi):
        dims = vi["type"]["tensor_type"]["shape"].get("dim", [])
        return [int(d.get("dim_value") or 0) for d in dims]

    def init_hidden(self, batch_size=None):
        if self._graph is None:
            self._load()
        if not self._hidden_inputs:
            return None
        lead = list(batch_size) if batch_size is not None else []
        return [np.zeros(lead + self._vi_shape(vi)[1:], np.float32)
                for vi in self._hidden_inputs]

    def inference(self, x, hidden=None, batch_input=False):
        if self._graph is None:
            self._load()
        feeds = dict(self._init)
        leaves = tree_leaves(x)
        if hidden is not None:
            leaves = leaves + list(tree_leaves(hidden))
        vis = self._data_inputs + self._hidden_inputs
        if len(leaves) != len(vis):
            raise ValueError(
                f"model expects {len(vis)} inputs, got {len(leaves)}")
        for vi, leaf in zip(vis, leaves):
            # honor the graph's declared input dtype: third-party
            # graphs legitimately take int/bool feeds
            code = vi["type"]["tensor_type"].get("elem_type", DT_FLOAT)
            arr = np.asarray(leaf, _DTYPES.get(code, np.float32))
            feeds[vi["name"]] = arr if batch_input else arr[None]
        results = _Runner(self._graph.get("node", []), feeds).run(
            self._outputs)
        if not batch_input:
            results = [r[0] for r in results]
        outputs = dict(zip(self._outputs, results))
        hidden_out = [outputs.pop(k) for k in list(outputs)
                      if k.startswith("hidden")]
        outputs["hidden"] = hidden_out or None
        return outputs
