"""Tensor parallelism: shard the Gaussian mixture over a mesh axis.

Counterpart of ``gvr_tpu/parallel/gauss_sharded.py``.  Data parallelism
(``sharding.py``) replicates the scene, which is right while the
parameters fit one card.  What outgrows a card first is the dense path's
per-(ray, Gaussian) working set, O(rays x N) float32 intermediates.
Sharding the *Gaussian* axis divides that working set and the per-pair
work over ranks, while rays shard over a second axis: a 2-D
(``rays`` x ``gauss``) mesh.

Each rank holds the rows of its ``gauss`` coordinate (``gauss_rows``) and
the rays of its ``rays`` coordinate, and runs the dense engine
(``multiscatter_radiance``, ``mc_camera_rays``, ``fit_loss``) inside
``ops/gaxis.gaussian_axis(group)``: every Gaussian-axis reduction
completes with an all-reduce over the rank's ``gauss`` group, so per-ray
control flow (the bracketed Newton loop, Russian roulette, the loop's
early exit) sees the same values on every rank of that group and stays
in lockstep.  A collective carries a few scalars per ray.  The functions
take the JAX package's global arguments and slice them by the rank's
mesh coordinate; every rank returns the whole result.  Candidate
compaction is forced off (top-k over a sharded axis has no cheap
collective, and the gauss axis itself shrinks the working set).  The
float32 sums are split by shard, so results agree with one device up to
reduction order.
"""

from __future__ import annotations

import dataclasses
import datetime

import torch

from gvr_tpu_torch.config import RenderConfig
from gvr_tpu_torch.ops.gaxis import gaussian_axis
from gvr_tpu_torch.parallel.sharding import (RAY_AXIS, TIMEOUT, Mesh,
                                             assemble, grid_mesh,
                                             shard_bounds)
from gvr_tpu_torch.scene.gaussians import (PARAMS_PER_GAUSSIAN,
                                           GaussianMixture)
from gvr_tpu_torch.scene.scene import Scene

GAUSS_AXIS = "gauss"


def make_mesh_2d(n_ray_shards: int, n_gauss_shards: int, ranks=None,
                 timeout: datetime.timedelta = TIMEOUT) -> Mesh:
    """(rays x gauss) mesh over the first n_ray*n_gauss ranks of the job
    (or ``ranks``), row-major: the ranks of one row share a ``gauss``
    group.  Every rank of the job must call it."""
    return grid_mesh((RAY_AXIS, GAUSS_AXIS), (n_ray_shards, n_gauss_shards),
                     ranks, timeout)


def pad_mixture(gmm: GaussianMixture, multiple: int) -> GaussianMixture:
    """N padded up to a multiple with inert Gaussians: zero density and
    albedo, unit covariance and a mean so remote (1e9) that the support
    test fails for every finite ray, so padded rows hit nothing and leave
    brackets, far bounds and NEE as they were."""
    rem = (-gmm.n) % multiple
    if rem == 0:
        return gmm
    dev = gmm.mean.device
    pad = GaussianMixture.from_covariances(
        mean=torch.full((rem, 3), 1e9), cov=torch.eye(3).repeat(rem, 1, 1),
        density=torch.zeros(rem), albedo=torch.zeros(rem), device=dev)
    return GaussianMixture(*(torch.cat([getattr(gmm, f.name),
                                        getattr(pad, f.name)])
                             for f in dataclasses.fields(gmm)))


def gauss_rows(gmm: GaussianMixture, mesh: Mesh) -> GaussianMixture:
    """This rank's rows of ``gmm`` (N divisible by the gauss axis)."""
    a, b = shard_bounds(gmm.n, mesh, GAUSS_AXIS)
    return GaussianMixture(*(getattr(gmm, f.name)[a:b]
                             for f in dataclasses.fields(gmm)))


def gather_gauss(local: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """A ``gauss``-sharded tensor [n_local, ...] (rows of the mixture, or
    a flat parameter vector or gradient [N/tp * 11]) back to the whole
    [n_local * gauss, ...] on every rank of the group."""
    k = mesh.shape[GAUSS_AXIS]
    n = local.shape[0]
    return assemble(local, n * k, mesh.index(GAUSS_AXIS) * n, mesh,
                    GAUSS_AXIS)


def _local_scene(scene: Scene, mesh: Mesh) -> Scene:
    medium = pad_mixture(scene.medium, mesh.shape[GAUSS_AXIS])
    return scene.with_medium(gauss_rows(medium, mesh))


def render_rays_tp(scene: Scene, origin, direction, rng_ids,
                   cfg: RenderConfig, mesh: Mesh, sample=0) -> torch.Tensor:
    """Multi-scatter radiance [B,3] of rays origin/direction [B,3] with the
    rays sharded over ``rays`` and the mixture over ``gauss``: the
    estimator of ``multiscatter_radiance`` up to float32 reduction order,
    its streams keyed by rng_ids, so layout-independent like the data
    parallel path.  B must divide by the ``rays`` axis."""
    from gvr_tpu_torch.integrators.multiscatter import multiscatter_radiance

    cfg = dataclasses.replace(cfg, candidate_k=0)
    sc = _local_scene(scene, mesh)
    n = origin.shape[0]
    a, b = shard_bounds(n, mesh, RAY_AXIS)
    with gaussian_axis(mesh.group(GAUSS_AXIS)):
        local = multiscatter_radiance(sc, origin[a:b], direction[a:b],
                                      rng_ids[a:b], cfg, sample=sample)
    return assemble(local, n, a, mesh)


def render_multiscatter_tp(scene: Scene, camera, cfg: RenderConfig,
                           mesh: Mesh) -> torch.Tensor:
    """Image-level tensor-parallel render, [H*W, 3] in pixel-id order on
    the scene's device: pixels shard over ``rays``, the mixture over
    ``gauss``, and each rank runs the spp loop over its pixels (the
    stratified jitter and per-sample streams of the one-device estimator,
    keyed by (pixel, sample, bounce), never by shard).  The working-set
    escape hatch; ``render_multiscatter`` stays the default."""
    from gvr_tpu_torch.integrators.multiscatter import (
        mc_camera_rays, multiscatter_radiance)

    cfg = dataclasses.replace(cfg, candidate_k=0)
    sc = _local_scene(scene, mesh)
    dev = scene.env_color.device
    n = cfg.width * cfg.height
    k = mesh.shape[RAY_AXIS]
    n_pad = -(-n // k) * k
    a, b = shard_bounds(n_pad, mesh, RAY_AXIS)
    ids = torch.arange(a, b, dtype=torch.int32, device=dev) % n
    acc = torch.zeros((b - a, 3), dtype=torch.float32, device=dev)
    with gaussian_axis(mesh.group(GAUSS_AXIS)):
        for si in range(cfg.spp):
            o, d, rng_ids = mc_camera_rays(sc, camera, cfg, ids, si)
            acc = acc + multiscatter_radiance(sc, o, d, rng_ids, cfg,
                                              sample=si)
    return assemble(acc / cfg.spp, n_pad, a, mesh)[:n]


def fit_value_and_grad_tp(mesh: Mesh, n_bounces: int = 4,
                          loss: str = "l2_dual", rr_after: int = 0):
    """value_and_grad of the inverse-rendering loss with the parameters
    themselves sharded: each rank owns params[N/tp * 11] of the mixture
    (and may own the matching slice of Adam state: Adam is elementwise),
    and rays and targets shard over ``rays``: model x data parallel
    fitting, for mixtures whose [rays, N] fit working set outgrows one
    card.

    Returns ``f(params, lights_p, lights_i, env_color, o, d, rng_ids,
    target, seed) -> (loss, grad)`` for the global params [N*11] (N
    divisible by the gauss axis; pad upstream) and rays (their count
    divisible by the rays axis): the loss replicated, ``grad`` the
    gradient of this rank's params slice (``gather_gauss`` puts it
    together), both averaged over ``rays``.  The backward pass runs
    inside the gauss axis, where the checkpointed recompute and the
    conditional solve's VJP need their all-reduces; the identity backward
    of ``gsum`` hands each rank the cotangent of its own partials, so the
    gradient needs no collective over ``gauss``."""
    from gvr_tpu_torch.inverse.fit import fit_loss

    def f(params, lights_p, lights_i, env_color, o, d, rng_ids, target,
          seed):
        template = Scene(None, lights_p, lights_i, env_color)
        per = PARAMS_PER_GAUSSIAN
        ga, gb = shard_bounds(params.shape[0] // per, mesh, GAUSS_AXIS)
        p = params[ga * per:gb * per].detach().requires_grad_(True)
        a, b = shard_bounds(o.shape[0], mesh, RAY_AXIS)
        with gaussian_axis(mesh.group(GAUSS_AXIS)):
            val = fit_loss(p, template, o[a:b], d[a:b], rng_ids[a:b],
                           target[a:b], n_bounces=n_bounces, loss=loss,
                           seed=int(seed), rr_after=rr_after)
            (grad,) = torch.autograd.grad(val, p)
        both = torch.cat([val.detach().reshape(1), grad])
        group = mesh.group(RAY_AXIS)
        if group is not None:
            torch.distributed.all_reduce(both, group=group)
            both = both / mesh.shape[RAY_AXIS]
        return both[0], both[1:]

    return f
