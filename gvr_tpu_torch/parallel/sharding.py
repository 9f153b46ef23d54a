"""Data parallelism over rays: ranks of a ``torch.distributed`` job.

Counterpart of ``gvr_tpu/parallel/sharding.py``.  The JAX package shards
the flat ray batch over a 1-D device ``Mesh`` with ``shard_map`` from one
controller; here each device is a rank of a process group (one process
per device, ``torchrun`` or ``parallel/launch.spawn``), and a ``Mesh``
lays the ranks out on named axes.  The scene is replicated (20k
Gaussians x 11 parameters are 220 KB); each rank takes its contiguous
slice of the leading ray axis, and the result is assembled on every rank
by one all-reduce of a zero-filled buffer into which each rank wrote its
own rows (x + 0 = x, so the assembly is exact on any backend).  Radiance
is keyed by pixel id (``ops/sampling``), so a sharded image is the
one-process image.  Fitting needs one collective: the loss and gradient,
summed and divided by the rank count (gloo has no ``ReduceOp.AVG``).

The tensor-parallel axis over the Gaussians lives in ``gauss_sharded.py``.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
from typing import Callable, Optional, Sequence

import torch
import torch.distributed as dist

RAY_AXIS = "rays"
# every process group's timeout: a rank that misses a collective fails the
# job after this long instead of hanging it
TIMEOUT = datetime.timedelta(minutes=30)


def init_process_group(device: str = "cuda", rank: Optional[int] = None,
                       world_size: Optional[int] = None,
                       init_method: Optional[str] = None,
                       timeout: datetime.timedelta = TIMEOUT,
                       backend: Optional[str] = None) -> torch.device:
    """Join the job's default process group and return this rank's
    device: ``cuda:(local rank % cards)`` (made the current device), or
    the CPU where ``device`` is 'cpu'.  Rank, world size and local rank
    default to torchrun's environment (RANK, WORLD_SIZE, LOCAL_RANK,
    LOCAL_WORLD_SIZE; ``init_method`` env://).  The backend is NCCL where
    every rank of the host has a card of its own and gloo on the CPU and
    where ranks share a card, which NCCL refuses.  Any failure raises."""
    env = os.environ
    rank = int(env["RANK"]) if rank is None else rank
    world_size = int(env["WORLD_SIZE"]) if world_size is None else world_size
    local_rank = int(env.get("LOCAL_RANK", rank))
    local_world = int(env.get("LOCAL_WORLD_SIZE", world_size))
    if torch.device(device).type == "cpu":
        dev = torch.device("cpu")
        backend = backend or "gloo"
    else:
        cards = torch.cuda.device_count()
        if cards == 0:
            raise RuntimeError(f"device {device!r}: no CUDA card is visible")
        dev = torch.device("cuda", local_rank % cards)
        torch.cuda.set_device(dev)
        backend = backend or ("nccl" if local_world <= cards else "gloo")
    dist.init_process_group(backend, init_method=init_method or "env://",
                            world_size=world_size, rank=rank,
                            timeout=timeout)
    return dev


@dataclasses.dataclass(frozen=True)
class Mesh:
    """Ranks of the default group laid out row-major on named axes.

    ``axis_names`` and ``dims`` name and size the axes; ``ranks`` lists
    the mesh's global ranks row-major; ``coords`` is this rank's index on
    each axis (None where this rank is outside the mesh); ``groups`` its
    process group along each axis (None where the axis has one rank)."""

    axis_names: tuple
    dims: tuple
    ranks: tuple
    coords: Optional[tuple]
    groups: tuple

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.dims))

    @property
    def size(self) -> int:
        n = 1
        for d in self.dims:
            n *= d
        return n

    def index(self, axis: str) -> int:
        if self.coords is None:
            raise ValueError(f"rank {dist.get_rank()} is not in the mesh "
                             f"of ranks {self.ranks}")
        return self.coords[self.axis_names.index(axis)]

    def group(self, axis: str):
        self.index(axis)
        return self.groups[self.axis_names.index(axis)]


def _new_group(ranks: Sequence[int], timeout):
    """A process group of ``ranks`` (every rank of the job must call this,
    in the same order), or None for a single rank."""
    if len(ranks) == 1:
        return None
    if len(ranks) == dist.get_world_size():
        return dist.group.WORLD
    return dist.new_group(list(ranks), timeout=timeout)


def grid_mesh(axis_names: Sequence[str], dims: Sequence[int],
              ranks: Optional[Sequence[int]] = None,
              timeout: datetime.timedelta = TIMEOUT) -> Mesh:
    """A mesh of ``dims`` over ``ranks`` (default: the first prod(dims)
    ranks of the job), with a group along each axis.  Outside a
    distributed job it is the one-rank mesh; a larger one then raises."""
    axis_names, dims = tuple(axis_names), tuple(int(d) for d in dims)
    need = 1
    for d in dims:
        need *= d
    if not dist.is_initialized():
        if need != 1:
            raise RuntimeError(f"a mesh of {need} ranks needs an "
                               f"initialized process group")
        return Mesh(axis_names, dims, (0,), (0,) * len(dims),
                    (None,) * len(dims))
    world = dist.get_world_size()
    ranks = tuple(range(need)) if ranks is None else tuple(ranks)
    if len(ranks) != need or not all(0 <= r < world for r in ranks):
        raise ValueError(f"a {dims} mesh needs {need} of the job's {world} "
                         f"ranks, got {ranks}")
    me = dist.get_rank()
    pos = ranks.index(me) if me in ranks else None
    coords = None
    if pos is not None:
        coords, rest = [], pos
        for d in reversed(dims):
            coords.append(rest % d)
            rest //= d
        coords = tuple(reversed(coords))
    strides = [1] * len(dims)
    for i in range(len(dims) - 2, -1, -1):
        strides[i] = strides[i + 1] * dims[i + 1]
    groups = []
    for a, d in enumerate(dims):
        # the lines along axis a: every combination of the other indices
        mine = None
        for base in range(need):
            if (base // strides[a]) % d:
                continue
            line = [ranks[base + k * strides[a]] for k in range(d)]
            g = _new_group(line, timeout)
            if me in line:
                mine = g
        groups.append(mine)
    return Mesh(axis_names, dims, ranks, coords, tuple(groups))


def make_mesh(ranks: Optional[Sequence[int]] = None, axis: str = RAY_AXIS,
              timeout: datetime.timedelta = TIMEOUT) -> Mesh:
    """1-D mesh over all (or the given) ranks of the job; forward rendering
    is data parallel over rays, so one axis is the whole story.  Outside
    a distributed job it is the one-rank mesh."""
    if ranks is None and dist.is_initialized():
        ranks = range(dist.get_world_size())
    n = 1 if ranks is None else len(tuple(ranks))
    return grid_mesh((axis,), (n,), ranks, timeout)


def shard_rays(n: int, n_devices: int) -> int:
    """Round a ray count up to a multiple of the device count."""
    return ((n + n_devices - 1) // n_devices) * n_devices


def shard_bounds(n: int, mesh: Mesh, axis: str = RAY_AXIS) -> tuple:
    """(start, stop) of this rank's contiguous slice of ``n`` rows, which
    must divide by the axis size."""
    k = mesh.shape[axis]
    if n % k:
        raise ValueError(f"{n} rows do not divide over the {k} ranks of "
                         f"axis '{axis}'; pad them upstream")
    i = mesh.index(axis)
    return i * (n // k), (i + 1) * (n // k)


def assemble(local: torch.Tensor, n: int, start: int, mesh: Mesh,
             axis: str = RAY_AXIS) -> torch.Tensor:
    """The [n, ...] tensor whose rows start:start+len(local) are this
    rank's ``local`` and the others the other ranks' of ``axis``: one
    all-reduce (SUM) of a zero-filled buffer."""
    out = torch.zeros((n,) + tuple(local.shape[1:]), dtype=local.dtype,
                      device=local.device)
    out[start:start + local.shape[0]] = local
    group = mesh.group(axis)
    if group is not None:
        dist.all_reduce(out, group=group)
    return out


def shard_last_arg(fn: Callable, mesh: Mesh, n_args: int) -> Callable:
    """Wrap ``fn(*replicated_args, ids) -> [B, ...]`` so each rank renders
    its slice of the trailing ray-id batch and every rank returns the
    whole [B, ...]; the other ``n_args - 1`` arguments (scene, grid,
    camera) are replicated.  The JAX package's production multi-chip
    forward path; radiance is shard-invariant, its streams keyed by pixel
    id."""

    def wrapped(*args):
        if len(args) != n_args:
            raise TypeError(f"expected {n_args} arguments, got {len(args)}")
        ids = args[-1]
        start, stop = shard_bounds(ids.shape[0], mesh)
        local = fn(*args[:-1], ids[start:stop])
        return assemble(local, ids.shape[0], start, mesh)

    return wrapped


def sharded_render_fn(radiance_fn: Callable, mesh: Mesh) -> Callable:
    """Wrap ``radiance_fn(scene, rays...) -> [B, 3]`` so the ray batch is
    split over the mesh: the scene is replicated, each rank traces its
    slice of every ray argument's leading axis, and every rank returns
    the whole [B, 3]."""

    def wrapped(scene, *ray_args):
        n = ray_args[0].shape[0]
        start, stop = shard_bounds(n, mesh)
        local = radiance_fn(scene, *(a[start:stop] for a in ray_args))
        return assemble(local, n, start, mesh)

    return wrapped


def sharded_value_and_grad(loss_fn: Callable, mesh: Mesh) -> Callable:
    """(loss, gradient) of ``loss_fn(params, scene_template, rays...,
    targets)``, a mean over the rays, with rays and targets split over
    the mesh: each rank differentiates its slice's loss, and one
    all-reduce sums the losses and gradients, which are then divided by
    the rank count (the mean of equal shards' means is the global mean).
    Returns detached tensors, the same on every rank."""

    def wrapped(params, template, *sharded_args):
        start, stop = shard_bounds(sharded_args[0].shape[0], mesh)
        p = params.detach().requires_grad_(True)
        loss = loss_fn(p, template, *(a[start:stop] for a in sharded_args))
        (grad,) = torch.autograd.grad(loss, p)
        group = mesh.group(RAY_AXIS)
        if group is None:
            return loss.detach(), grad
        both = torch.cat([loss.detach().reshape(1), grad.reshape(-1)])
        dist.all_reduce(both, group=group)
        both = both / mesh.shape[RAY_AXIS]
        return both[0], both[1:].reshape(grad.shape)

    return wrapped
