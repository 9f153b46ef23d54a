"""Inverse rendering: fit Gaussian parameters to a target image by autodiff.

Counterpart of ``gvr_tpu/inverse/fit.py`` (reference
``StochasticFiniteDiffInverseIntegrator``, inverse_integrator.h:59-246).
The estimator itself is differentiable (``multiscatter_radiance_diff``:
analytic escape, implicit-function free flight), so one render's worth of
work gives pathwise gradients through autograd, and Adam
(``torch.optim.Adam``, the update of ``optax.adam``) steps the reference's
11-parameter codec (gmm.h:583-674).  Each iteration renders a random
minibatch of pixels, drawn as the JAX package draws them.  It runs on the
device of the scene; in a distributed job it is data parallel over the
ranks of a ``rays`` mesh (``parallel/sharding``), as the JAX package's
fit is over its devices: every rank draws the same batch, traces its
slice, and one all-reduce averages the loss and the gradient, so the
parameters and Adam's state stay the same on every rank.  Checkpoints
(.npz) keep the JAX package's layout, so a fit started in either package
resumes in the other.
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Callable, Optional

import numpy as np
import torch
import torch.distributed as dist
from torch.utils.checkpoint import checkpoint

from gvr_tpu_torch.config import FitConfig, RenderConfig
from gvr_tpu_torch.integrators.multiscatter import (
    diff_uniforms, multiscatter_radiance_diff)
from gvr_tpu_torch.integrators.test_hit import pixel_rays
from gvr_tpu_torch.parallel.sharding import (make_mesh, shard_rays,
                                             sharded_value_and_grad)
from gvr_tpu_torch.scene.convert import params_from_numpy
from gvr_tpu_torch.scene.gaussians import GaussianMixture
from gvr_tpu_torch.scene.scene import Scene

LOSSES = ("l2_dual", "l2", "l1")


@dataclasses.dataclass
class FitState:
    """params [N*11]; opt_state, the Adam state of params
    (``torch.optim.Adam.state[params]``: 'step', 'exp_avg',
    'exp_avg_sq'); iteration, the last one applied."""

    params: torch.Tensor
    opt_state: dict
    iteration: int


def _mc_mean(render: Callable, sample_ids, draw: Callable) -> torch.Tensor:
    """The mean of ``render(si, xi)`` over the samples, xi = ``draw(si)``,
    each render under a non-reentrant checkpoint: its intermediates are
    recomputed in the backward pass instead of kept, so memory stays O(1)
    in the sample count, the counterpart of ``jax.checkpoint`` in a
    ``lax.scan``.  The draws are made outside the checkpoint, so the
    recompute launches no K3."""
    tot = None
    for si in sample_ids:
        out = checkpoint(render, si, draw(si), use_reentrant=False,
                         preserve_rng_state=False)
        tot = out if tot is None else tot + out
    return tot / len(sample_ids)


def fit_loss(params: torch.Tensor, scene_template: Scene, origin, direction,
             rng_ids, target, n_bounces: int = 4, spp: int = 1,
             loss: str = "l2_dual", seed: int = 0, candidate_k: int = 0,
             rr_after: int = 0) -> torch.Tensor:
    """Loss between the differentiable estimate of rays origin/direction
    [B,3] (streams rng_ids [B]) and target [B,3], a scalar tensor with a
    graph to ``params``.  ``seed`` refreshes the MC streams (the fit
    passes the iteration's seed word).

    * 'l2_dual': two independent estimates x1, x2 of spp samples each;
      the gradient of mean((x1 - t) sg(x2 - t)) is an unbiased estimate of
      that of (E[x] - t)^2, where the naive L2 of a noisy estimate is
      biased toward dimmer, quieter renders;
    * 'l1' (the reference's pixel loss, inverse_integrator.h:20-29) and
      'l2': plain, for low-noise settings and the gradient checks.

    K3 launches once for each buffer and sample (``diff_uniforms``)."""
    if loss not in LOSSES:
        raise ValueError(f"loss must be 'l2_dual', 'l2' or 'l1', "
                         f"got {loss!r}")
    scene = scene_template.with_medium(GaussianMixture.from_parameters(params))

    def render(si, xi):
        return multiscatter_radiance_diff(
            scene, origin, direction, rng_ids, None, n_bounces=n_bounces,
            sample=si, seed=seed, candidate_k=candidate_k,
            rr_after=rr_after, xi=xi)

    def draw(si):
        return diff_uniforms(rng_ids, si, n_bounces, seed)

    if loss == "l2_dual":
        e1 = _mc_mean(render, [2 * i for i in range(spp)], draw) - target
        e2 = _mc_mean(render, [2 * i + 1 for i in range(spp)], draw) - target
        return 0.5 * torch.mean(e1 * e2.detach() + e1.detach() * e2)
    err = _mc_mean(render, list(range(spp)), draw) - target
    if loss == "l2":
        return torch.mean(err * err)
    return torch.mean(torch.abs(err))


def _pixel_rays(camera, width: int, height: int, ids: torch.Tensor):
    """(o, d, ids): rays through the centres of pixel ids [B]."""
    o, d = pixel_rays(camera, RenderConfig(width=width, height=height), ids)
    return o, d, ids


def fit_gaussians(scene_init: Scene, camera, target_img: np.ndarray,
                  cfg: FitConfig = FitConfig(), batch_pixels: int = 4096,
                  n_bounces: int = 4, spp: Optional[int] = None,
                  mesh=None, log: Callable = print,
                  save_snapshot: Optional[Callable] = None,
                  candidate_k: int = 0, rr_after: int = 0,
                  resume: Optional[str] = None) -> Scene:
    """Run the Adam fit on the device of ``scene_init``; returns the
    fitted scene (detached).

    target_img: [H,W,3] float.  mesh: the ``rays`` mesh the batch shards
    over (``parallel.sharding.make_mesh()``, every rank of the job or the
    one process, by default); batch_pixels is rounded up to a multiple of
    its size.  Only its first rank logs and writes checkpoints.
    save_snapshot(iteration, scene), if given, is called on every rank
    (a render over the mesh is collective) under ``torch.no_grad()`` on
    the iterations that log.  spp defaults to cfg.spp.  candidate_k > 0 compacts the solve to each ray's
    candidate_k nearest-entering Gaussians (and probes, on the iterations
    that log, the share of live lanes that dropped candidates); rr_after >
    0 turns Russian roulette on from that bounce.  resume: a ckpt.npz of
    either package; the fit continues after its iteration, and draws the
    batches and streams the uninterrupted run would (each iteration's are
    derived from (cfg.seed, iteration))."""
    scene_init.require_gaussian("fit_gaussians")
    h, w = target_img.shape[:2]
    spp = cfg.spp if spp is None else spp
    dev = scene_init.medium.mean.device
    camera = camera.to(dev)
    params = scene_init.medium.pack_parameters().detach().clone() \
        .requires_grad_(True)
    optimizer = torch.optim.Adam([params], lr=cfg.lr)
    mesh = mesh if mesh is not None else make_mesh()
    batch_pixels = shard_rays(batch_pixels, mesh.size)
    lead = not dist.is_initialized() or dist.get_rank() == mesh.ranks[0]
    if not lead:
        log = lambda msg: None
    start_iter = 0
    if resume is not None and os.path.exists(resume):
        start_iter = load_checkpoint(resume, optimizer, params).iteration + 1
        log(f"[fit] resumed {resume} at iteration {start_iter}")
    target_flat = torch.as_tensor(np.asarray(target_img, np.float32)
                                  .reshape(-1, 3), device=dev)

    def mixture():
        return GaussianMixture.from_parameters(params.detach())

    t0 = time.time()
    if lead:
        os.makedirs(cfg.out_dir, exist_ok=True)
    for it in range(start_iter, cfg.max_iters):
        # each iteration's batch and streams derive from (cfg.seed, it),
        # so a resumed run draws what the uninterrupted one would
        ids = torch.from_numpy(np.random.default_rng(
            (cfg.seed << 20) + it).integers(0, w * h, batch_pixels,
                                            dtype=np.int32)).to(dev)
        o, d, rng_ids = _pixel_rays(camera, w, h, ids)
        tgt = target_flat[ids.long()]
        # the seed word, masked to 32 bits by the RNG as the JAX package
        # masks its uint32 seed array
        seed = (cfg.seed << 20) + it

        over = ""
        if lead and candidate_k > 0 and it % cfg.save_every == 0:
            # the overflow of this step's gradients: the pre-update
            # params and this step's streams, over live lanes only
            with torch.no_grad():
                _, (n_over, n_live) = multiscatter_radiance_diff(
                    scene_init.with_medium(mixture()), o, d, rng_ids, None,
                    n_bounces=n_bounces, seed=seed, candidate_k=candidate_k,
                    rr_after=rr_after, return_overflow=True)
            n_over, n_live = int(n_over), int(n_live)
            frac = n_over / max(n_live, 1)
            over = f" cand-overflow {frac:.2%} ({n_live} live lanes)"
            if frac > 0.01:
                log(f"[fit] WARNING: {frac:.2%} of live lanes dropped "
                    f"candidates (candidate_k={candidate_k} too small "
                    f"— gradients are biased)")

        value_and_grad = sharded_value_and_grad(
            lambda p, template, *rays: fit_loss(
                p, template, *rays, n_bounces=n_bounces, spp=spp, seed=seed,
                candidate_k=candidate_k, rr_after=rr_after), mesh)
        loss, params.grad = value_and_grad(params, scene_init, o, d,
                                           rng_ids, tgt)
        optimizer.step()

        if it % cfg.save_every == 0:
            log(f"[fit] iter {it} loss {loss.item():.5f} "
                f"elapsed {time.time() - t0:.1f}s{over}")
            if save_snapshot is not None:
                with torch.no_grad():
                    save_snapshot(it, scene_init.with_medium(mixture()))
        if lead and cfg.checkpoint_every \
                and it % cfg.checkpoint_every == 0:
            save_checkpoint(os.path.join(cfg.out_dir, "ckpt.npz"),
                            FitState(params, optimizer.state[params], it))
    return scene_init.with_medium(mixture())


# -----------------------------------------------------------------------------
# Checkpoint / resume in the JAX package's layout: params, iteration and
# the leaves of optax.adam's state in flattening order, opt_0 the step
# count (int32), opt_1 the first moment, opt_2 the second.
# -----------------------------------------------------------------------------

def save_checkpoint(path: str, state: FitState) -> None:
    """Write ``state`` (its Adam state may be empty: no step yet)."""
    p = state.params.detach().cpu().numpy()
    st = state.opt_state
    count = int(st["step"]) if "step" in st else 0
    moment = lambda k: (st[k].detach().cpu().numpy() if k in st
                        else np.zeros_like(p))
    np.savez(path, params=p, iteration=state.iteration,
             opt_0=np.int32(count), opt_1=moment("exp_avg"),
             opt_2=moment("exp_avg_sq"))


def load_checkpoint(path: str, optimizer: torch.optim.Adam,
                    params: torch.Tensor) -> FitState:
    """Read a checkpoint of either package into ``params`` (in place) and
    its Adam state in ``optimizer``, which must hold ``params``."""
    with np.load(path) as data:
        with torch.no_grad():
            params.copy_(params_from_numpy(data["params"], params.device))
        optimizer.state[params] = {
            "step": torch.tensor(float(data["opt_0"]), dtype=torch.float32),
            "exp_avg": params_from_numpy(data["opt_1"], params.device),
            "exp_avg_sq": params_from_numpy(data["opt_2"], params.device)}
        iteration = int(data["iteration"])
    return FitState(params, optimizer.state[params], iteration)
