"""Sharded learner update step over a rank mesh.

The counterpart of ``handyrl_tpu.parallel.update``.  JAX lays the step
out over a mesh with ``in_shardings``/``out_shardings`` and lets XLA
insert the collectives; eager PyTorch places them by hand, one process
per rank, around the port's :class:`~..ops.update.UpdateStep`:

  * ``dp`` — each rank runs forward and backward on its OWN rows, then
    the gradients are SUMMED over dp (one coalesced ``all_reduce``), as
    are the loss metrics and ``dcnt``: the loss is a sum over the batch
    (the lr schedule normalizes by the data-count EMA), so the global
    gradient is the sum of the per-rank ones — never their mean, which
    is what DDP and FSDP do by default;
  * ``fsdp`` — each leaf the JAX rule dp-shards holds its dp chunk (on
    the dim the rule picks) as a DTensor ``Shard(d)`` over dp; the
    owning module's forward all-gathers the whole leaf over dp and the
    backward reduce-scatters its gradient with SUM, so the gradient
    arrives summed over dp and sharded like the leaf.  Parameters and
    Adam moments are dp-sharded DTensors; the leaves the rule keeps
    replicated stay plain tensors, summed with the rest;
  * ``tp`` — wide conv/dense kernels hold their output-feature slice as
    a DTensor ``Shard(0)`` over tp; DTensor has no sharding strategy
    for a convolution with a sharded weight, so the owning module's
    forward computes its slice of the output channels and all-gathers
    them (the backward keeps its slice; the input's gradient is summed
    over tp, Megatron's "f"/"g" pair).  A bias, replicated by the rule,
    is added after the gather.  With ``fsdp`` a kernel may shard on
    both axes (tp on its output features, dp on the last other dim the
    rule finds divisible): the dp gather comes first and yields the
    rank's tp slice;
  * ``sp`` (``shard_time``) — a feed-forward forward runs on this rank's
    slice of the time axis (when ``T % sp == 0``) and the outputs are
    gathered back before the targets' reverse scans; a recurrent net
    runs its whole window on every rank.  Gradients of a split forward
    are summed over sp as well.

The global-norm clip is over the GLOBAL gradient: the squared norms of
sharded gradients are summed over the axes that shard them.  With every
axis of size 1 the step is the unsharded step's arithmetic: the
collectives run over one rank, and the parameters come out bit for bit
the same.

The dp shards are placed by hand rather than by FSDP2's ``fully_shard``:
one mechanism carries dp-only, tp-only and doubly-sharded leaves alike,
each leaf's placements are exactly :func:`.mesh.param_sharding`'s on the
whole mesh (no ``_StridedShard``), and the reductions are the step's own
sums with no divide factor to override.
"""

import types

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch.distributed.tensor import DTensor

from ..ops.losses import LossConfig
from ..ops.update import UpdateStep, local_tensor, make_optimizer
from ..utils.tree import tree_map_leaves
from .mesh import AXES, axis_size, param_sharding, replicated


class _SumGrad(torch.autograd.Function):
    """Identity forward; the backward sums the gradient over ``group``
    (the input of a tp-sharded kernel feeds every rank's slice)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


class _Gather(torch.autograd.Function):
    """All-gather along ``dim`` over ``group``; the backward keeps this
    rank's slice (every rank of the group computes the same loss
    downstream, so the upstream gradient is the same on each)."""

    @staticmethod
    def forward(ctx, x, group, dim):
        n = dist.get_world_size(group)
        ctx.dim, ctx.size = dim, x.shape[dim]
        ctx.index = dist.get_rank(group)
        parts = [torch.empty_like(x) for _ in range(n)]
        dist.all_gather(parts, x.contiguous(), group=group)
        return torch.cat(parts, dim=dim)

    @staticmethod
    def backward(ctx, grad):
        return (grad.narrow(ctx.dim, ctx.index * ctx.size,
                            ctx.size).contiguous(), None, None)


class _GatherShards(torch.autograd.Function):
    """All-gather a dp-sharded leaf along ``dim`` over ``group``; the
    backward reduce-scatters the gradient with SUM (each dp rank's rows
    contributed to the whole leaf), so this rank's chunk of the gradient
    arrives summed over dp."""

    @staticmethod
    def forward(ctx, x, group, dim):
        n = dist.get_world_size(group)
        ctx.group, ctx.dim = group, dim
        parts = [torch.empty_like(x) for _ in range(n)]
        dist.all_gather(parts, x.contiguous(), group=group)
        return torch.cat(parts, dim=dim)

    @staticmethod
    def backward(ctx, grad):
        n = dist.get_world_size(ctx.group)
        whole = grad.movedim(ctx.dim, 0).contiguous()
        part = whole.new_empty((whole.shape[0] // n,) + whole.shape[1:])
        dist.reduce_scatter_tensor(part, whole, group=ctx.group)
        return part.movedim(0, ctx.dim).contiguous(), None, None


def _leaf(self, name):
    """A laid-out module's parameter ``name`` as its forward uses it:
    this rank's part, with the dp shards gathered."""
    t = getattr(self, name)
    if t is None:
        return None
    local = t.to_local() if isinstance(t, DTensor) else t
    dim = self._dp_dims.get(name)
    if dim is None:
        return local
    return _GatherShards.apply(local, self._dp_group, dim)


def _sharded_forward(self, x):
    """A laid-out Conv2d's or Linear's forward: the dp-sharded leaves
    gathered; with a tp-sharded kernel, this rank's output channels
    gathered over tp, then the replicated bias."""
    weight, bias = _leaf(self, "weight"), _leaf(self, "bias")
    conv = isinstance(self, torch.nn.Conv2d)
    group = self._tp_group
    if group is None:
        if conv:
            return self._conv_forward(x, weight, bias)
        return F.linear(x, weight, bias)
    x = _SumGrad.apply(x, group)
    if conv:
        y = _Gather.apply(self._conv_forward(x, weight, None), group, 1)
        shape = (1, -1, 1, 1)
    else:
        y = _Gather.apply(F.linear(x, weight), group, -1)
        shape = (-1,)
    if bias is not None:
        y = y + bias.to(y.dtype).view(shape)
    return y


def _shard(full, mesh, placements):
    """A DTensor of ``full`` laid out by ``placements``, built from the
    local chunk each rank already holds (no communication)."""
    local = full
    for axis, p in enumerate(placements):
        if p.is_shard():
            local = local.chunk(mesh.size(axis), p.dim)[
                mesh.get_local_rank(axis)]
    return DTensor.from_local(local.contiguous(), mesh, tuple(placements),
                              run_check=False, shape=full.shape,
                              stride=full.contiguous().stride())


def shard_module(module, mesh, layouts):
    """Lay ``module``'s parameters out by ``layouts`` (from
    :func:`.mesh.param_sharding`), in place: each leaf sharded on any
    axis becomes a DTensor parameter holding this rank's chunk, and its
    owner (a Conv2d or Linear) computes with its dp chunks gathered and,
    when tp shards its kernel, its slice of the output.  Returns the
    set of dp-sharded parameters (their gradients arrive summed)."""
    tp_axis, dp_axis = AXES.index("tp"), AXES.index("dp")
    named = dict(module.named_parameters())
    dp_sharded = set()
    for name in sorted(n for n, lay in layouts.items()
                       if not lay.is_fully_replicated):
        owner_name, _, leaf = name.rpartition(".")
        owner = module.get_submodule(owner_name)
        placements = layouts[name].placements
        tp, dp = placements[tp_axis], placements[dp_axis]
        if (leaf not in ("weight", "bias")
                or not isinstance(owner, (torch.nn.Conv2d, torch.nn.Linear))
                or (tp.is_shard() and (leaf != "weight" or tp.dim != 0))
                or placements[AXES.index("sp")].is_shard()):
            raise ValueError(f"layout of {name} has no sharded forward "
                             f"(only Conv2d/Linear leaves shard, over tp "
                             f"on their output features only)")
        param = torch.nn.Parameter(
            _shard(named[name].detach(), mesh, placements))
        setattr(owner, leaf, param)
        if not hasattr(owner, "_dp_dims"):
            owner._dp_dims, owner._tp_group = {}, None
            owner._dp_group = mesh.get_group(dp_axis)
            owner.forward = types.MethodType(_sharded_forward, owner)
        if tp.is_shard():
            owner._tp_group = mesh.get_group(tp_axis)
        if dp.is_shard():
            owner._dp_dims[leaf] = dp.dim
            dp_sharded.add(param)
    return dp_sharded


def full_tensor(t):
    """A plain tensor holding all of ``t`` (a collective for a sharded
    DTensor: every rank of its mesh must call it).  Gathered with plain
    ``all_gather`` calls per sharded mesh axis: DTensor's own
    ``full_tensor`` waits on functional collectives, which crash the
    process over gloo on CUDA tensors (torch 2.11)."""
    if not isinstance(t, DTensor):
        return t
    full = t.to_local().detach()
    mesh = t.device_mesh
    for axis in reversed(range(mesh.ndim)):
        p = t.placements[axis]
        if p.is_shard():
            group = mesh.get_group(axis)
            parts = [torch.empty_like(full)
                     for _ in range(dist.get_world_size(group))]
            dist.all_gather(parts, full.contiguous(), group=group)
            full = torch.cat(parts, dim=p.dim)
    if tuple(full.shape) != tuple(t.shape):
        raise ValueError(f"uneven shards: gathered {tuple(full.shape)}, "
                         f"want {tuple(t.shape)}")
    return full


def full_state_dict(module):
    """``module.state_dict()`` with every sharded tensor gathered (a
    collective when anything is sharded)."""
    return {k: full_tensor(v) for k, v in module.state_dict().items()}


def _sum_(tensors, group):
    """Sum each tensor over ``group`` in place: ONE all_reduce of their
    concatenation."""
    if not tensors:
        return
    flat = torch.cat([t.reshape(-1) for t in tensors])
    dist.all_reduce(flat, group=group)
    for t, part in zip(tensors, flat.split([t.numel() for t in tensors])):
        t.copy_(part.view_as(t))


def opt_state_sharding(layouts, mesh):
    """Layouts of the Adam state, derived structurally: the moments
    inherit their parameter's layout, the step count replicates."""
    return {"exp_avg": dict(layouts), "exp_avg_sq": dict(layouts),
            "step": replicated(mesh)}


class ShardedUpdateStep(UpdateStep):
    """:class:`~..ops.update.UpdateStep` over a rank mesh.  Each rank
    calls it on its own rows (local tensors, or DTensor views of the
    global batch); the returned metrics are global on every rank."""

    def __init__(self, module, cfg: LossConfig, mesh, learning_rate,
                 compute_dtype="float32", target_module=None,
                 shard_time=False, fsdp=False):
        layouts = param_sharding(mesh, module, fsdp=fsdp)
        self.fsdp_params = shard_module(module, mesh, layouts)
        if target_module is not None:
            # the IMPACT target is the same net: the same layout
            shard_module(target_module, mesh, layouts)
        super().__init__(module, cfg,
                         make_optimizer(module.parameters(), learning_rate),
                         compute_dtype, target_module=target_module)
        self.dp_group = mesh.get_group(AXES.index("dp"))
        self.sp = axis_size(mesh, "sp") if shard_time else 1
        self.sp_group = mesh.get_group(AXES.index("sp"))
        self.recurrent = hasattr(module, "init_hidden")
        self._window = None    # (B, T, P) of the step's batch, when split
        if self.sp > 1:
            self.apply_fn = self._split_time(self.apply_fn)
            if self.target_apply_fn is not None:
                self.target_apply_fn = self._split_time(self.target_apply_fn)

    # -- sequence parallelism ------------------------------------------
    def _split_time(self, apply_fn):
        """``apply_fn`` on this rank's slice of T, outputs gathered back
        to the whole window (feed-forward calls only)."""
        sp, group = self.sp, self.sp_group
        index = dist.get_rank(group)

        def split_apply(obs, hidden=None):
            if hidden is not None or self._window is None:
                return apply_fn(obs, hidden)
            B, T, P = self._window
            # torchlint: disable=unsynced-divisibility -- loss_and_grads sets self._window only when T % sp == 0, so the split is even
            span = T // sp

            def cut(a):
                a = a.reshape((B, T, P) + a.shape[1:])
                a = a[:, index * span:(index + 1) * span]
                return a.reshape((-1,) + a.shape[3:])

            def join(v):
                v = v.reshape((B, span, P) + v.shape[1:])
                v = _Gather.apply(v, group, 1)
                return v.reshape((B * T * P,) + v.shape[3:])

            out = apply_fn(tree_map_leaves(cut, obs), None)
            return {k: tree_map_leaves(join, v) for k, v in out.items()}

        return split_apply

    # -- the step ----------------------------------------------------------
    def loss_and_grads(self, batch):
        """Forward + backward on this rank's rows, then the gradients
        and the metrics summed over the mesh."""
        batch = tree_map_leaves(local_tensor, batch)
        B, T, P = batch["action"].shape[:3]
        split = (self.sp > 1 and not self.recurrent and T > 1
                 and T % self.sp == 0)
        self._window = (B, T, P) if split else None
        try:
            losses, dcnt = super().loss_and_grads(batch)
        finally:
            self._window = None
        grads = [(p, p.grad) for p in self.params if p.grad is not None]
        # the dp-sharded leaves' reduce-scatter already summed them
        _sum_([local_tensor(g) for p, g in grads
               if p not in self.fsdp_params], self.dp_group)
        if split:
            # each rank's forward covered its slice of T only
            _sum_([local_tensor(g) for _, g in grads], self.sp_group)
        return self._sum_metrics(losses, dcnt)

    def _sum_metrics(self, losses, dcnt):
        """Loss components and ``dcnt`` summed over dp (every sp/tp rank
        of a dp group computed the same loss); ``clip_frac`` is a
        fraction of the acting steps, so it is re-weighted by them."""
        keys = sorted(losses)
        denom = dcnt.detach().float() + 1e-8
        vec = torch.stack(
            [losses[k].detach().float()
             * (denom if k == "clip_frac" else 1.0) for k in keys]
            + [dcnt.detach().float()])
        dist.all_reduce(vec, group=self.dp_group)
        total = dict(zip(keys, vec[:-1].unbind()))
        if "clip_frac" in total:
            total["clip_frac"] = total["clip_frac"] / (vec[-1] + 1e-8)
        return total, vec[-1]

    def grad_norm(self, grads):
        """The global gradient's norm: a sharded gradient's squared
        local norm is summed over the mesh axes that shard it."""
        norms = list(torch._foreach_norm([local_tensor(g) for g in grads]))
        sharded = {}
        for i, g in enumerate(grads):
            if isinstance(g, DTensor):
                axes = tuple(a for a, p in enumerate(g.placements)
                             if p.is_shard())
                if axes:
                    sharded.setdefault((g.device_mesh, axes), []).append(i)
        for (mesh, axes), index in sharded.items():
            squares = torch.stack([norms[i] ** 2 for i in index])
            for axis in axes:
                dist.all_reduce(squares, group=mesh.get_group(axis))
            for j, i in enumerate(index):
                norms[i] = squares[j].sqrt()
        return torch.linalg.vector_norm(torch.stack(norms))

    # -- the optimizer state in the unsharded step's format ----------------
    def optimizer_state(self):
        """The Adam state as the unsharded optimizer's ``state_dict``
        (one group, params indexed in ``module.parameters()`` order,
        full tensors): every rank must call it when anything is
        sharded."""
        group = dict(self.optimizer.state_dict()["param_groups"][0])
        group["params"] = list(range(len(self.params)))
        state = {i: {k: full_tensor(v) for k, v in
                     self.optimizer.state[p].items()}
                 for i, p in enumerate(self.params)
                 if p in self.optimizer.state}
        return {"state": state, "param_groups": [group]}

    def load_optimizer_state(self, opt_state):
        """Restore :meth:`optimizer_state`'s format (host arrays) into
        the sharded optimizer: each moment laid out like its param."""
        impl = ("fused", "foreach", "capturable", "differentiable",
                "params")
        saved = opt_state["param_groups"][0]
        for group in self.optimizer.param_groups:
            group.update({k: v for k, v in saved.items() if k not in impl})
        for i, s in opt_state["state"].items():
            p = self.params[int(i)]
            fused = any(g["fused"] for g in self.optimizer.param_groups
                        if any(q is p for q in g["params"]))
            local = local_tensor(p)
            state = {}
            for k, v in s.items():
                v = torch.as_tensor(v)
                if k == "step":
                    state[k] = v.to(device=local.device if fused else "cpu",
                                    dtype=torch.float32)
                    continue
                v = v.to(device=local.device, dtype=local.dtype)
                state[k] = (_shard(v, p.device_mesh, p.placements)
                            if isinstance(p, DTensor) else v)
            self.optimizer.state[p] = state


def make_sharded_update_step(module, cfg: LossConfig, mesh, learning_rate,
                             compute_dtype="float32", target_module=None,
                             shard_time=False, fsdp=False):
    """Lay ``module`` (and the IMPACT ``target_module``) out over
    ``mesh`` and build its step and Adam: ``step(local_rows) ->
    metrics``, collective on every rank of the mesh.  ``shard_time``
    splits the time axis over ``sp``; ``fsdp`` shards parameters and
    moments over ``dp`` (ZeRO)."""
    return ShardedUpdateStep(module, cfg, mesh, learning_rate,
                             compute_dtype=compute_dtype,
                             target_module=target_module,
                             shard_time=shard_time, fsdp=fsdp)

