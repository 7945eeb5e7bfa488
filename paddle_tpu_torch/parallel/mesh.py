"""Device meshes and axis conventions (paddle_tpu/parallel/mesh.py).

The JAX package lays a `jax.sharding.Mesh` over the chips one controller
sees. Here the axes that carry data between workers are
`torch.distributed` process groups, one rank a process: NCCL between
cards, gloo on the CPU (the backend follows the device,
parallel/distributed.py). The pipeline axis is different: its stages run
in one process, each on a device of that process's list, so `pp` names
devices and never ranks.

  dp — data parallel (batch)            ≙ trainer_count / num trainers
  mp — model parallel (sharded params)  ≙ pserver parameter blocks
  sp — sequence parallel (long context) — parallel/ring_attention.py
  pp — pipeline stages                  ≙ ParallelNeuralNetwork device attr

The rank axes take the world's ranks in row-major order, as the JAX mesh
reshapes its device list. A placement (`replicated`, `batch_sharded`,
`dim_sharded`) is one entry a dimension, an axis name or None, as a
PartitionSpec is; a Variable's `.sharding` holds one, and the mesh
executor reads it as the JAX package's executor reads a NamedSharding.
"""

from __future__ import annotations

import re
from collections import OrderedDict
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

DP, MP, SP, PP = "dp", "mp", "sp", "pp"

# the full textual vocabulary: parse_mesh_spec rejects anything else, so a
# typo ("ddp8") fails at the CLI instead of naming an axis no rule matches
KNOWN_AXES = (DP, MP, SP, PP)


class Mesh:
    """Named axes over the world's ranks (dp, mp, sp) and this process's
    devices (pp). `shape` maps each axis to its size, as a JAX mesh's;
    `group(axis)` is this rank's process group along a rank axis (None
    without torch.distributed); `axis_index(axis)` its coordinate there;
    `pp_devices` the devices of the pp axis, one a stage slice (None
    without a pp axis)."""

    def __init__(self, shape: Sequence[int], axis_names: Sequence[str],
                 devices: Optional[Sequence] = None):
        import torch.distributed as dist

        from . import distributed

        if len(shape) != len(axis_names):
            raise ValueError(f"mesh shape {tuple(shape)} and axes {tuple(axis_names)} differ "
                             "in length")
        self.axis_names = tuple(axis_names)
        self.shape: Dict[str, int] = OrderedDict(
            (a, int(n)) for a, n in zip(axis_names, shape))
        self.rank_axes = tuple(a for a in self.axis_names if a != PP)
        sizes = tuple(self.shape[a] for a in self.rank_axes)
        world = distributed.process_count()
        if int(np.prod(sizes)) != world:
            raise ValueError(f"mesh shape {tuple(shape)} ({'x'.join(map(str, sizes)) or '1'} "
                             f"ranks) != {world} processes")
        self.ranks = np.arange(world).reshape(sizes) if sizes else np.zeros((), int)
        self.rank = distributed.process_index()
        coords = np.argwhere(self.ranks == self.rank)[0] if sizes else ()
        self._coords = dict(zip(self.rank_axes, (int(c) for c in coords)))
        pp = self.shape.get(PP, 1)
        if devices is None and PP in self.shape:
            devices = [distributed.device()] * pp
        self.pp_devices = [torch.device(d) for d in devices or ()] or None
        if self.pp_devices is not None and len(self.pp_devices) != pp:
            raise ValueError(f"mesh pp axis of {pp} needs {pp} devices, got "
                             f"{len(self.pp_devices)}")
        # every process builds every group, in the same order (new_group's rule)
        self._groups: Dict[str, object] = {}
        if dist.is_available() and dist.is_initialized():
            for i, a in enumerate(self.rank_axes):
                lines = np.moveaxis(self.ranks, i, -1).reshape(-1, self.shape[a])
                for line in lines:
                    g = dist.new_group([int(r) for r in line])
                    if self.rank in line:
                        self._groups[a] = g

    @property
    def devices(self) -> np.ndarray:
        """The ranks laid out on the rank axes (the JAX mesh's device array)."""
        return self.ranks

    def size(self, axis: str) -> int:
        return self.shape.get(axis, 1)

    def group(self, axis: str):
        """This rank's process group along `axis` (None without
        torch.distributed, where every rank axis has size 1)."""
        if axis not in self.shape or axis == PP:
            raise ValueError(f"{axis!r} is not a rank axis of the mesh {dict(self.shape)}")
        return self._groups.get(axis)

    def axis_index(self, axis: str) -> int:
        return self._coords.get(axis, 0)

    def axis_ranks(self, axis: str) -> List[int]:
        """The global ranks of this rank's line along `axis`, in axis order."""
        i = self.rank_axes.index(axis)
        idx = [self._coords[a] for a in self.rank_axes]
        out = []
        for c in range(self.shape[axis]):
            idx[i] = c
            out.append(int(self.ranks[tuple(idx)]))
        return out

    def __repr__(self):
        return f"Mesh({dict(self.shape)}, rank {self.rank})"


class Placement:
    """A value's layout over a mesh: `spec` has one entry a dimension, an
    axis name or None (the JAX package's NamedSharding(mesh, spec))."""

    def __init__(self, mesh: Mesh, spec: Tuple[Optional[str], ...]):
        self.mesh = mesh
        self.spec = tuple(spec)

    def __repr__(self):
        return f"Placement({self.spec})"


def make_mesh(shape: Optional[Sequence[int]] = None, axis_names: Sequence[str] = (DP,),
              devices=None) -> Mesh:
    """Build a Mesh. Default: every process on one `dp` axis."""
    from . import distributed

    if shape is None:
        shape = (distributed.process_count(),)
    return Mesh(shape, axis_names, devices)


def parse_mesh_spec(spec: str) -> Tuple[Tuple[str, int], ...]:
    """"dp4,pp2" -> (("dp", 4), ("pp", 2)): the textual mesh vocabulary of
    bench.py's BENCH_MESH and the CLI's --mesh. Axis names are KNOWN_AXES."""
    axes = []
    for part in filter(None, spec.split(",")):
        m = re.fullmatch(r"([a-z]+)(\d+)", part.strip())
        if not m:
            raise ValueError(f"bad mesh axis {part!r}; want e.g. dp4 or pp2")
        name, size = m.group(1), int(m.group(2))
        if name not in KNOWN_AXES:
            raise ValueError(f"unknown mesh axis {name!r} in {part!r}; "
                             f"known axes: {', '.join(KNOWN_AXES)}")
        if size < 1:
            raise ValueError(f"mesh axis {part!r} must have size >= 1")
        if any(a == name for a, _ in axes):
            raise ValueError(f"duplicate mesh axis {name!r} in {spec!r}")
        axes.append((name, size))
    if not axes:
        raise ValueError(f"empty mesh spec {spec!r}")
    return tuple(axes)


def mesh_from_spec(spec: str, devices=None) -> Mesh:
    """Build a Mesh from "dp2,pp2": the rank axes over the world's
    processes, pp over `devices` (default: this process's device, once a
    stage)."""
    axes = parse_mesh_spec(spec)
    return make_mesh(shape=tuple(n for _, n in axes), axis_names=tuple(a for a, _ in axes),
                     devices=devices)


def replicated(mesh: Mesh) -> Placement:
    return Placement(mesh, ())


def batch_sharded(mesh: Mesh, axis: str = DP, ndim: int = 2) -> Placement:
    """Shard dim 0 (batch) over `axis`, replicate the rest."""
    return Placement(mesh, (axis,) + (None,) * (ndim - 1))


def dim_sharded(mesh: Mesh, dim: int, axis: str, ndim: int) -> Placement:
    spec = [None] * ndim
    spec[dim] = axis
    return Placement(mesh, tuple(spec))


def local_slice(mesh: Mesh, spec, shape) -> List[List[int]]:
    """[[start, stop], ...] of the global `shape` this rank holds under
    `spec` (a dimension whose axis has size n is cut in n equal pieces)."""
    out = []
    for d, dim in enumerate(shape):
        ax = spec[d] if d < len(spec) else None
        if ax is None or mesh.size(ax) == 1:
            out.append([0, int(dim)])
            continue
        n = mesh.size(ax)
        if dim % n:
            raise ValueError(f"dimension {d} of size {dim} is not divisible by the mesh's "
                             f"{ax} axis ({n})")
        i = mesh.axis_index(ax)
        out.append([i * dim // n, (i + 1) * dim // n])
    return out


def slice_owner(mesh: Mesh, spec) -> bool:
    """Whether this rank is the one of its slice's replicas that writes it
    (coordinate 0 on every rank axis the spec does not cut)."""
    used = {a for a in spec if a is not None}
    return all(mesh.axis_index(a) == 0 for a in mesh.rank_axes if a not in used)
