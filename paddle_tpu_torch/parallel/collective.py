"""Collective communication (paddle_tpu/parallel/collective.py).

The JAX package's wrappers are `lax` collectives named by a shard_map
axis. Here each is a `torch.distributed` call on the process group of a
mesh axis (`mesh.group(axis)`; with no mesh, the whole world): NCCL
between cards, gloo on the CPU. Each returns a new tensor and leaves its
input as it was. `ring_all_reduce` is the JAX package's own ring, neighbour
exchanges by send/recv (MultiGradientMachine.h:63-110's software ring);
`shard_map_fn` runs a function on each rank's shard of global values.

The autograd Functions at the end are the Megatron pair (an identity whose
backward all-reduces, an all-reduce whose backward is the identity), a
gather along the last dimension whose backward keeps this rank's piece,
and an all-to-all whose backward is the inverse all-to-all: the tensor
parallel layers and Ulysses attention differentiate through them.
"""

from __future__ import annotations

import torch


def _line(axis_name: str, mesh=None):
    """(group, size, index, global ranks) of this rank along the axis."""
    import torch.distributed as dist

    from . import distributed

    if mesh is None:
        n = distributed.process_count()
        return None, n, distributed.process_index(), list(range(n))
    return (mesh.group(axis_name), mesh.size(axis_name), mesh.axis_index(axis_name),
            mesh.axis_ranks(axis_name)) if dist.is_initialized() else \
        (None, 1, 0, [0])


def all_reduce(x: torch.Tensor, axis_name: str, mesh=None) -> torch.Tensor:
    """NCCL allreduce parity (nccl_op.cc ncclAllReduce): the sum over the
    axis."""
    import torch.distributed as dist

    group, _, _, _ = _line(axis_name, mesh)
    out = x.detach().clone()
    if dist.is_initialized():
        dist.all_reduce(out, group=group)
    return out


def all_gather(x: torch.Tensor, axis_name: str, axis: int = 0, tiled: bool = True,
               mesh=None) -> torch.Tensor:
    """Every rank's x, concatenated along `axis` (tiled) or stacked on a new
    leading axis."""
    import torch.distributed as dist

    group, n, _, _ = _line(axis_name, mesh)
    x = x.detach().contiguous()
    parts = [torch.empty_like(x) for _ in range(n)]
    if dist.is_initialized():
        dist.all_gather(parts, x, group=group)
    else:
        parts = [x.clone()]
    return torch.cat(parts, axis) if tiled else torch.stack(parts, 0)


def reduce_scatter(x: torch.Tensor, axis_name: str, axis: int = 0, mesh=None) -> torch.Tensor:
    """The sum over the axis, cut in n pieces along `axis`: this rank's."""
    import torch.distributed as dist

    group, n, i, _ = _line(axis_name, mesh)
    if x.shape[axis] % n:
        raise ValueError(f"reduce_scatter: dimension {axis} of {tuple(x.shape)} is not "
                         f"divisible by {n}")
    if not dist.is_initialized():
        return x.detach().clone()
    parts = [p.contiguous() for p in torch.chunk(x.detach(), n, axis)]
    out = torch.empty_like(parts[0])
    dist.reduce_scatter(out, parts, group=group)
    return out


def broadcast(x: torch.Tensor, axis_name: str, root: int = 0, mesh=None) -> torch.Tensor:
    """NCCL bcast parity: every rank takes the value of the axis's rank
    `root`."""
    import torch.distributed as dist

    group, _, _, ranks = _line(axis_name, mesh)
    out = x.detach().clone()
    if dist.is_initialized():
        dist.broadcast(out, ranks[root], group=group)
    return out


def ppermute_ring(x: torch.Tensor, axis_name: str, shift: int = 1, mesh=None) -> torch.Tensor:
    """Neighbour exchange on the ring: rank i's x goes to rank i + shift;
    returns what rank i - shift sent."""
    import torch.distributed as dist

    group, n, i, ranks = _line(axis_name, mesh)
    if n == 1:
        return x.detach().clone()
    x = x.detach().contiguous()
    out = torch.empty_like(x)
    ops = [dist.P2POp(dist.isend, x, ranks[(i + shift) % n], group),
           dist.P2POp(dist.irecv, out, ranks[(i - shift) % n], group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return out


def ring_all_reduce(x: torch.Tensor, axis_name: str, mesh=None) -> torch.Tensor:
    """Educational parity with MultiGradientMachine's software ring
    (MultiGradientMachine.h:63-110), as the JAX package writes it: the
    chunked buffer goes round the ring n - 1 times, each rank adding the
    chunk it owns as it passes, then the owned chunks are gathered. Prefer
    all_reduce: NCCL's is already ring-scheduled."""
    _, n, i, _ = _line(axis_name, mesh)
    if n == 1:
        return x.detach().clone()
    flat = x.detach().reshape(-1)
    if flat.numel() % n:
        raise ValueError(f"ring_all_reduce: {flat.numel()} elements do not split in {n}")
    buf = flat.reshape(n, -1)
    acc = buf[i].clone()
    for _ in range(1, n):
        buf = ppermute_ring(buf, axis_name, shift=1, mesh=mesh)
        acc = acc + buf[i]
    return all_gather(acc, axis_name, axis=0, mesh=mesh).reshape(x.shape)


def _spec_slices(spec, shape, mesh) -> tuple:
    from .mesh import local_slice

    return tuple(slice(a, b) for a, b in local_slice(mesh, tuple(spec or ()), shape))


def shard_map_fn(fn, mesh, in_specs, out_specs):
    """jax.shard_map's counterpart: the returned function takes global
    values (the same on every rank), hands `fn` this rank's shard of each
    (cut by its spec, one axis name or None a dimension) and reassembles
    each output from every rank's shard along its spec's axes."""
    def run(*args):
        local = [a[_spec_slices(s, a.shape, mesh)] for a, s in zip(args, in_specs)]
        outs = fn(*local)
        single = not isinstance(outs, (tuple, list))
        outs = [outs] if single else list(outs)
        specs = [out_specs] if single else list(out_specs)
        full = []
        for o, s in zip(outs, specs):
            for d, ax in enumerate(tuple(s or ())):
                if ax is not None and mesh.size(ax) > 1:
                    o = all_gather(o, ax, axis=d, mesh=mesh)
            full.append(o)
        return full[0] if single else tuple(full)

    return run


# -- autograd through collectives ---------------------------------------------

def _ar(x, group):
    import torch.distributed as dist

    x = x.contiguous().clone()
    if dist.is_initialized():
        dist.all_reduce(x, group=group)
    return x


class _CopyToGroup(torch.autograd.Function):
    """Identity forward; the backward all-reduces (a replicated input to a
    column-split product, whose gradient each rank holds a part of)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _ar(g, ctx.group), None


class _ReduceFromGroup(torch.autograd.Function):
    """All-reduce forward (a row-split product's partial sums); identity
    backward."""

    @staticmethod
    def forward(ctx, x, group):
        return _ar(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherLast(torch.autograd.Function):
    """All-gather along the last dimension; the backward keeps this rank's
    piece of the gradient."""

    @staticmethod
    def forward(ctx, x, group, n, i):
        import torch.distributed as dist

        ctx.n, ctx.i = n, i
        x = x.contiguous()
        parts = [torch.empty_like(x) for _ in range(n)]
        dist.all_gather(parts, x, group=group)
        return torch.cat(parts, -1)

    @staticmethod
    def backward(ctx, g):
        w = g.shape[-1] // ctx.n
        return g[..., ctx.i * w:(ctx.i + 1) * w].contiguous(), None, None, None


def _all_to_all(x: torch.Tensor, split: int, concat: int, group, n: int) -> torch.Tensor:
    """jax.lax.all_to_all(tiled=True): x cut in n pieces along `split`,
    piece j to rank j; the pieces received, in rank order, concatenated
    along `concat`."""
    import torch.distributed as dist

    if n == 1 and not dist.is_initialized():
        return x
    pieces = torch.stack(torch.chunk(x, n, split), 0).contiguous()
    out = torch.empty_like(pieces)
    dist.all_to_all_single(out, pieces, group=group)
    return torch.cat(list(out.unbind(0)), concat)


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, split, concat, group, n):
        ctx.args = (split, concat, group, n)
        return _all_to_all(x, split, concat, group, n)

    @staticmethod
    def backward(ctx, g):
        split, concat, group, n = ctx.args
        return _all_to_all(g.contiguous(), concat, split, group, n), None, None, None, None


def copy_to_group(x, group):
    return _CopyToGroup.apply(x, group)


def reduce_from_group(x, group):
    return _ReduceFromGroup.apply(x, group)


def gather_last(x, group, n: int, i: int):
    return _GatherLast.apply(x, group, n, i) if n > 1 else x


def all_to_all(x, split: int, concat: int, group, n: int):
    return _AllToAll.apply(x, split, concat, group, n)
