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
  * ``fsdp`` — FSDP2 ``fully_shard`` over the dp axis, each leaf on the
    dim the JAX rule picks (``shard_placement_fn``), the leaves the rule
    keeps replicated left out (``ignored_params``, summed with the
    rest); gradient divide factor 1 with SUM reductions, so its
    reduce-scatter sums too.  Parameters and Adam moments are dp-sharded
    DTensors;
  * ``tp`` — wide conv/dense kernels hold their output-feature slice as
    a DTensor ``Shard(0)`` over tp; DTensor has no sharding strategy
    for a convolution with a sharded weight, so the owning module's
    forward computes its slice of the output channels and all-gathers
    them (the backward keeps its slice; the input's gradient is summed
    over tp, Megatron's "f"/"g" pair).  A bias, replicated by the rule,
    is added after the gather;
  * ``sp`` (``shard_time``) — a feed-forward forward runs on this rank's
    slice of the time axis (when ``T % sp == 0``) and the outputs are
    gathered back before the targets' reverse scans; a recurrent net
    runs its whole window on every rank.  Gradients of a split forward
    are summed over sp as well.

The global-norm clip is over the GLOBAL gradient: the squared norms of
sharded gradients are summed over the axes that shard them.  With every
axis of size 1 the step is the unsharded step's arithmetic: the
collectives run over one rank, and the parameters come out bit for bit
the same.  ``fsdp`` with ``tp > 1`` is not ported (it raises).
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


def _tp_forward(self, x):
    """A tp-sharded Conv2d's or Linear's forward: this rank's output
    channels, gathered, then the replicated bias."""
    x = _SumGrad.apply(x, self._tp_group)
    weight = self.weight.to_local()
    if isinstance(self, torch.nn.Conv2d):
        y = _Gather.apply(self._conv_forward(x, weight, None),
                          self._tp_group, 1)
        shape = (1, -1, 1, 1)
    else:
        y = _Gather.apply(F.linear(x, weight), self._tp_group, -1)
        shape = (-1,)
    if self.bias is not None:
        y = y + self.bias.to(y.dtype).view(shape)
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


def _dp_sharded(layout):
    return layout.placements[AXES.index("dp")].is_shard()


def shard_module(module, mesh, layouts, fsdp=False):
    """Lay ``module``'s parameters out by ``layouts`` (from
    :func:`.mesh.param_sharding`), in place: tp-sharded kernels become
    DTensor parameters whose owner computes its output slice; with
    ``fsdp``, FSDP2 shards the dp-sharded leaves.  Returns the set of
    parameters FSDP2 manages (their gradients arrive summed)."""
    tp_axis = AXES.index("tp")
    named = dict(module.named_parameters())
    dp_leaves = {n for n, lay in layouts.items() if _dp_sharded(lay)}
    tp_leaves = {n for n, lay in layouts.items()
                 if lay.placements[tp_axis].is_shard()}
    if dp_leaves and tp_leaves:
        raise ValueError(
            "mesh {fsdp: true} with tp > 1 is not ported to "
            "handyrl_tpu_torch yet: use fsdp or tp")
    for name in sorted(tp_leaves):
        owner_name, _, leaf = name.rpartition(".")
        owner = module.get_submodule(owner_name)
        placements = layouts[name].placements
        if (leaf != "weight" or placements[tp_axis].dim != 0 or not
                isinstance(owner, (torch.nn.Conv2d, torch.nn.Linear))):
            raise ValueError(f"tp layout of {name} has no sharded "
                             f"forward (only Conv2d/Linear output "
                             f"features shard over tp)")
        owner.weight = torch.nn.Parameter(
            _shard(named[name].detach(), mesh, placements))
        owner._tp_group = mesh.get_group(tp_axis)
        owner.forward = types.MethodType(_tp_forward, owner)
    if not dp_leaves:
        return set()
    from torch.distributed.fsdp import fully_shard

    dim_of = {named[n]: layouts[n].placements[AXES.index("dp")]
              for n in dp_leaves}
    fully_shard(module, mesh=mesh["dp"],
                shard_placement_fn=lambda p: dim_of[p],
                ignored_params={p for n, p in named.items()
                                if n not in dp_leaves})
    # the loss is a sum over rows: reduce-scatter SUMS (no mean)
    divide = (getattr(module, "set_gradient_divide_factor", None)
              or module.set_reduce_scatter_divide_factor)
    divide(1.0)
    if hasattr(module, "set_force_sum_reduction_for_comms"):
        module.set_force_sum_reduction_for_comms(True)
    return {p for p in module.parameters() if isinstance(p, DTensor)}


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
        self.fsdp_params = shard_module(module, mesh, layouts, fsdp)
        self.target_fsdp = False
        if target_module is not None:
            # the IMPACT target is the same net: the same layout
            self.target_fsdp = bool(
                shard_module(target_module, mesh, layouts, fsdp))
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
        if self.target_fsdp:
            # FSDP2 keeps a root's parameters gathered after a forward
            # that no backward follows: back to the shards the target
            # refresh pairs with the live ones
            self.target_module.reshard()
        grads = [(p, p.grad) for p in self.params if p.grad is not None]
        # FSDP2's reduce-scatter already summed its leaves over dp
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
                    state[k] = v.to(torch.float32,
                                    device=local.device if fused else "cpu")
                    continue
                v = v.to(local.dtype, device=local.device)
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

