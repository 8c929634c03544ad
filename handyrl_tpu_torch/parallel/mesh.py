"""Mesh construction and layout rules, over ranks.

The counterpart of ``handyrl_tpu.parallel.mesh``.  JAX builds a ``Mesh``
of the devices one controller process sees; PyTorch runs one process
per card, so the port's mesh is a ``torch.distributed`` ``DeviceMesh``
over RANKS: a mesh of size N needs a process group of N ranks
(:func:`.multihost.init_distributed`), each rank owning one device.
Where the JAX messages say "devices", a device here is a rank.

Axes and their order are the JAX package's (any may be size 1):
  dp — data parallel: the batch rows
  sp — sequence parallel: the time axis of feed-forward batches
  tp — tensor parallel: the output features of wide conv/dense kernels
plus the ``fsdp`` rule toggle (parameters and Adam moments additionally
shard over ``dp``, ZeRO-style; not an axis).

A layout is a :class:`Layout`: the mesh and one DTensor placement per
mesh axis, in AXES order (``Shard(d)`` or ``Replicate()``), the
counterpart of JAX's ``NamedSharding``.  The rules are the JAX rules,
written on the Flax leaf shapes (a kernel's output features are its
LAST axis) and mapped through ``models.convert``'s axis permutation
onto the port's tensors (OIHW conv weights, ``(out, in)`` Linear
weights): the port shards the same logical axis of the same leaves as
the JAX package.  The rules are pure functions of the shapes and the
axis sizes, so a :class:`MeshSpec` stands in for a mesh wherever only
the plan is wanted (no process group needed).
"""

from dataclasses import dataclass
from typing import Any, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch
from torch.distributed.tensor import Replicate, Shard

# canonical axis order: data, sequence(time), tensor(model)
AXES = ("dp", "sp", "tp")


@dataclass(frozen=True)
class MeshSpec:
    """Logical mesh shape, e.g. ``MeshSpec(dp=4, tp=2)``.

    Axis sizes of 1 are kept in the mesh (so layouts never need to
    special-case a missing axis); the total size must fit the world.

    ``fsdp`` is a RULE toggle, not an axis: with it set, parameters and
    optimizer state additionally shard over the existing ``dp`` axis
    (ZeRO-style fully-sharded data parallelism)."""

    dp: int = 1
    sp: int = 1
    tp: int = 1
    fsdp: bool = False

    @classmethod
    def from_config(cls, mesh_cfg: Optional[Dict[str, int]]) -> "MeshSpec":
        mesh_cfg = dict(mesh_cfg or {})
        fsdp = bool(mesh_cfg.pop("fsdp", False))
        unknown = set(mesh_cfg) - set(AXES)
        if unknown:
            raise ValueError(f"unknown mesh axes: {sorted(unknown)}")
        return cls(fsdp=fsdp,
                   **{a: int(mesh_cfg.get(a, 1)) for a in AXES})

    @property
    def size(self) -> int:
        return self.dp * self.sp * self.tp

    def shape(self) -> Tuple[int, ...]:
        return (self.dp, self.sp, self.tp)


def check_mesh_size(spec: MeshSpec, n_devices: int) -> None:
    """The JAX package's size contract: a mesh larger than the world
    is an error; one that does not tile it leaves ranks idle, loudly."""
    if spec.size > n_devices:
        raise ValueError(
            f"mesh {spec.shape()} needs {spec.size} devices, have "
            f"{n_devices} — shrink the `mesh:` config axes "
            f"(dp/sp/tp) to fit the host, or launch with more devices"
        )
    if n_devices % spec.size != 0:
        print(f"WARNING: mesh {spec.shape()} uses {spec.size} of "
              f"{n_devices} devices ({n_devices - spec.size} "
              f"idle); set an explicit `mesh:` whose axes multiply to "
              f"a divisor of the device count (or make batch_size "
              f"divide evenly) to cover the host")


def make_mesh(spec: Optional[MeshSpec] = None, device_type: str = "cuda"):
    """A ``DeviceMesh`` over the first ``spec.size`` ranks of the
    default process group, axes named AXES.

    With no spec, every rank goes on ``dp`` — pure data parallelism.
    Every rank of the group must call this (it creates the axes'
    sub-groups)."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    world = dist.get_world_size() if dist.is_initialized() else 1
    if spec is None:
        spec = MeshSpec(dp=world)
    check_mesh_size(spec, world)
    return DeviceMesh(device_type,
                      torch.arange(spec.size).reshape(spec.shape()),
                      mesh_dim_names=AXES)


def axis_size(mesh, name: str) -> int:
    """The size of axis ``name`` of a ``DeviceMesh`` or a MeshSpec."""
    if isinstance(mesh, MeshSpec):
        return getattr(mesh, name)
    return mesh.size(mesh.mesh_dim_names.index(name))


class Layout(NamedTuple):
    """One tensor's layout over a mesh: the counterpart of JAX's
    ``NamedSharding``.  ``placements`` has one DTensor placement per
    mesh axis, in AXES order."""

    mesh: Any
    placements: Tuple[Any, ...]

    @property
    def is_fully_replicated(self) -> bool:
        return all(not p.is_shard() for p in self.placements)

    def spec(self, ndim: int) -> Tuple[Any, ...]:
        """JAX's PartitionSpec of the layout on an ``ndim`` tensor:
        per tensor axis, the mesh axis sharding it or None."""
        out = [None] * ndim
        for name, p in zip(AXES, self.placements):
            if p.is_shard():
                out[p.dim] = name
        return tuple(out)


def _placements(spec_axes) -> Tuple[Any, ...]:
    """Placements from a per-tensor-axis tuple of mesh-axis names."""
    return tuple(
        Shard(spec_axes.index(name)) if name in spec_axes else Replicate()
        for name in AXES)


def replicated(mesh) -> Layout:
    return Layout(mesh, (Replicate(),) * len(AXES))


def batch_sharding(mesh, time_axis: Optional[int] = None) -> Layout:
    """Batch tensors shard their leading dim over ``dp``; optionally the
    time axis over ``sp`` (sequence parallelism for long windows)."""
    return Layout(mesh, (Shard(0),
                         Replicate() if time_axis is None
                         else Shard(time_axis),
                         Replicate()))


# -- parameter layout rules (on Flax leaf shapes) -----------------------

def _tp_spec_for(shape: Tuple[int, ...], tp_size: int,
                 min_tp_dim: int) -> list:
    """Shard the output-feature (last) dim of large kernels over ``tp``.

    Conv kernels are (kh, kw, cin, cout) and dense kernels (cin, cout)
    in Flax — the last axis is always output features.  Small tensors
    (biases, norms, tiny heads) stay replicated: the all-gather cost
    would exceed the memory saved."""
    spec = [None] * len(shape)
    if tp_size <= 1 or len(shape) < 2:
        return spec
    last = shape[-1]
    if last % tp_size != 0 or last < min_tp_dim:
        return spec
    spec[-1] = "tp"
    return spec


def _fsdp_spec_for(shape: Tuple[int, ...], dp_size: int, spec: list,
                   min_fsdp_size: int) -> list:
    """Shard one dim of a large tensor over ``dp`` (ZeRO-style): the
    LAST dim divisible by ``dp`` that ``tp`` has not taken; small
    tensors stay replicated — sharding a bias saves nothing and costs
    an all-gather."""
    if dp_size <= 1 or not shape or int(np.prod(shape)) < min_fsdp_size:
        return spec
    for axis in range(len(shape) - 1, -1, -1):
        if spec[axis] is None and shape[axis] % dp_size == 0 \
                and shape[axis] >= dp_size:
            spec = list(spec)
            spec[axis] = "dp"
            return spec
    return spec


def flax_spec(shape, mesh, min_tp_dim: int = 128, fsdp: bool = False,
              min_fsdp_size: int = 4096) -> Tuple[Any, ...]:
    """The JAX package's PartitionSpec of one Flax-layout leaf, padded
    to the leaf's rank: per axis, ``"dp"``, ``"tp"`` or None."""
    shape = tuple(int(d) for d in shape)
    spec = _tp_spec_for(shape, axis_size(mesh, "tp"), min_tp_dim)
    if fsdp:
        spec = _fsdp_spec_for(shape, axis_size(mesh, "dp"), spec,
                              min_fsdp_size)
    return tuple(spec)


class InferenceShardings(NamedTuple):
    """The layout contract of one batched inference dispatch: params
    per :func:`param_sharding`, the observation rows over ``dp``, the
    outputs back on the same ``dp`` rows.  The port's service
    dispatches on one rank's card (see ``pipeline.service``), so a
    multi-rank contract is a plan here, not a dispatch."""

    params: Any
    obs: Layout
    out: Layout


def inference_shardings(mesh, params, min_tp_dim: int = 128,
                        fsdp: bool = False,
                        min_fsdp_size: int = 4096) -> InferenceShardings:
    """Layouts for the batched inference forward over ``mesh``; a
    single-rank mesh collapses all three to replication."""
    rows = Layout(mesh, (Shard(0), Replicate(), Replicate()))
    return InferenceShardings(
        params=param_sharding(mesh, params, min_tp_dim=min_tp_dim,
                              fsdp=fsdp, min_fsdp_size=min_fsdp_size),
        obs=rows, out=rows)


def param_sharding(mesh, params, min_tp_dim: int = 128,
                   fsdp: bool = False, min_fsdp_size: int = 4096):
    """Layouts of a net's parameters.

    ``params`` is a module of the port (the result maps each
    ``state_dict`` name to its Layout, the rules applied to the Flax
    shape of the leaf and mapped onto the port's axis), or a nested
    dict of Flax-layout arrays (the result has its structure, the
    rules applied to the arrays' own axes).  Default policy: replicate
    everything unless the mesh has a real ``tp`` axis, in which case
    wide kernels shard their output features; with ``fsdp``, large
    tensors additionally shard one dim over ``dp``."""
    kwargs = dict(min_tp_dim=min_tp_dim, fsdp=fsdp,
                  min_fsdp_size=min_fsdp_size)
    if isinstance(params, torch.nn.Module):
        from ..models.convert import _to_flax_shape, flax_layout, torch_axis

        shapes = {n: tuple(t.shape) for n, t in params.state_dict().items()}
        out = {}
        for _, name, kind in flax_layout(params):
            shape = shapes[name]
            spec = flax_spec(_to_flax_shape(shape, kind), mesh, **kwargs)
            torch_spec = [None] * len(shape)
            for axis, entry in enumerate(spec):
                torch_spec[torch_axis(kind, axis)] = entry
            out[name] = Layout(mesh, _placements(tuple(torch_spec)))
        return out

    def walk(tree):
        if isinstance(tree, dict):
            return {k: walk(v) for k, v in tree.items()}
        return Layout(mesh, _placements(
            flax_spec(np.shape(tree), mesh, **kwargs)))

    return walk(params)
