"""Per-pixel Gaussian attribution.

Counterpart of ``gvr_tpu/inverse/attribution.py`` (reference
RECORD_PIXEL_GAUSSIANS, integrator.h:415,526-545,616-644 and
inverse_integrator.h:125-131): which Gaussians contribute to which pixel,
as fixed-k arrays on the host.

* ``pixel_gaussians``: the k Gaussians each pixel's primary ray crosses,
  nearest entry first, and the count of those it crosses;
* ``pixel_gaussians_paths``: the reference's full recording, the union
  over sample paths of the Gaussians each scatter event touched (on a
  scatter, every one whose interval it entered before the scatter point;
  on an escape, every one ahead), replaying the renderer's own paths (the
  draws keyed by (pixel, sample, bounce), through ``uniform_planes``);
* ``gaussian_pixel_counts``: for each Gaussian, the pixels whose primary
  ray crosses it.

Each walks the pixels in chunks of ``pick_chunk(dense=True)`` on the
scene's device.
"""

from __future__ import annotations

import numpy as np
import torch

from gvr_tpu_torch.config import RenderConfig, Solver
from gvr_tpu_torch.integrators.common import pick_chunk
from gvr_tpu_torch.integrators.multiscatter import mc_camera_rays
from gvr_tpu_torch.integrators.test_hit import pixel_rays
from gvr_tpu_torch.kernels.rng import BOUNCE_DRAWS
from gvr_tpu_torch.kernels.wavefront import roulette
from gvr_tpu_torch.ops.quadratics import intersect_gaussians
from gvr_tpu_torch.ops.sampling import dir_from_xi, uniform_planes
from gvr_tpu_torch.ops.solvers import sample_free_flight
from gvr_tpu_torch.ops.transmittance import (albedo_at_from_rg,
                                             compact_candidates, tau_coeffs)
from gvr_tpu_torch.scene.scene import Scene


def _chunks(scene: Scene, cfg: RenderConfig):
    """(device, [ids] int32 tensors) covering the image in chunks."""
    dev = scene.medium.mean.device
    n = cfg.width * cfg.height
    ch = pick_chunk(cfg, scene.medium.n, dev, dense=True)
    return dev, [torch.arange(s, min(s + ch, n), dtype=torch.int32,
                              device=dev) for s in range(0, n, ch)]


def _primary_hits(scene: Scene, camera, cfg: RenderConfig, ids):
    """(t0, t1, hit) [B, N] of the rays through the pixel centres of ids."""
    return intersect_gaussians(scene.medium, *pixel_rays(camera, cfg, ids))


@torch.no_grad()
def pixel_gaussians(scene: Scene, camera, cfg: RenderConfig, k: int = 16):
    """([H*W, k] int32 Gaussian indices per pixel, -1 padded, by entry
    distance; [H*W] int32 counts of the Gaussians the ray crosses).  The
    order of equal entries is torch.topk's."""
    k = min(k, scene.medium.n)
    dev, chunks = _chunks(scene, cfg)
    camera = camera.to(dev)
    idx_out, cnt_out = [], []
    for ids in chunks:
        t0, _, hit = _primary_hits(scene, camera, cfg, ids)
        key = torch.where(hit, -torch.clamp(t0, min=0.0), -torch.inf)
        idx = torch.topk(key, k, dim=-1).indices
        idx_out.append(torch.where(torch.gather(hit, -1, idx), idx, -1))
        cnt_out.append(hit.sum(dim=-1))
    return (torch.cat(idx_out).to(torch.int32).cpu().numpy(),
            torch.cat(cnt_out).to(torch.int32).cpu().numpy())


def _path_membership(scene: Scene, camera, cfg: RenderConfig, ids,
                     sample: int) -> torch.Tensor:
    """[B, N] bool: the union over one sample path per pixel id of each
    bounce's contributing set, the path traced as ``multiscatter_radiance``
    traces it (the same draws, the same candidate compaction)."""
    gmm = scene.medium
    use_compact = 0 < cfg.candidate_k < gmm.n
    o, d, rng_ids = mc_camera_rays(scene, camera, cfg, ids, sample)
    b = o.shape[0]
    thr = torch.ones((b, 3), dtype=torch.float32, device=o.device)
    alive = torch.ones(b, dtype=torch.bool, device=o.device)
    mem = torch.zeros((b, gmm.n), dtype=torch.bool, device=o.device)
    for bounce in range(cfg.max_bounces):
        if not bool(alive.any()):
            break
        rg = tau_coeffs(gmm, o, d)
        rg_s, alb_k = rg, gmm.albedo
        if use_compact:
            rg_s, alb_k, _ = compact_candidates(rg, gmm.albedo,
                                                cfg.candidate_k)
        xi = uniform_planes(rng_ids, sample, bounce, BOUNCE_DRAWS, cfg.seed)
        target = -torch.log(torch.clamp(1.0 - xi[0], min=1e-12))
        t_sc, scattered = sample_free_flight(
            rg_s, target, cfg.solver, cfg.solver_iters,
            xi[8] if cfg.solver == Solver.UNIFORM else None,
            finisher=cfg.solver_finisher)
        # membership from the full set (the reference records every event
        # before the scatter, uncapped); the path from the solve above
        touched = torch.where(scattered[:, None],
                              rg.hit & (rg.t0 <= t_sc[:, None] + 1e-6),
                              rg.hit)
        mem |= touched & alive[:, None]
        pos = o + t_sc[:, None] * d
        albedo = albedo_at_from_rg(rg_s, alb_k, t_sc)
        thr_n, killed = roulette(cfg, thr, albedo, bounce, xi[5])
        alive = alive & scattered & ~killed
        o = torch.where(alive[:, None], pos, o)
        d = torch.where(alive[:, None], dir_from_xi(xi[6:8].T), d)
        thr = torch.where(alive[:, None], thr_n, thr)
    return mem


@torch.no_grad()
def pixel_gaussians_paths(scene: Scene, camera, cfg: RenderConfig,
                          k: int = 16, spp: int | None = None):
    """Multi-bounce attribution (integrator.h:616-644,
    inverse_integrator.h:125-131): ([H*W, k] int32 Gaussian indices per
    pixel, -1 padded, ascending; [H*W] int32 counts of the union) over
    ``spp`` sample paths a pixel (default cfg.spp).  A Gaussian reached
    only by a later bounce is here and not in ``pixel_gaussians``."""
    n = scene.medium.n
    k = min(k, n)
    spp = cfg.spp if spp is None else spp
    dev, chunks = _chunks(scene, cfg)
    camera = camera.to(dev)
    gidx = torch.arange(n, device=dev)
    idx_out, cnt_out = [], []
    for ids in chunks:
        acc = torch.zeros((ids.shape[0], n), dtype=torch.bool, device=dev)
        for s in range(spp):
            acc |= _path_membership(scene, camera, cfg, ids, s)
        first = torch.sort(torch.where(acc, gidx, n), dim=-1).values[:, :k]
        idx_out.append(torch.where(first < n, first, -1))
        cnt_out.append(acc.sum(dim=-1))
    return (torch.cat(idx_out).to(torch.int32).cpu().numpy(),
            torch.cat(cnt_out).to(torch.int32).cpu().numpy())


@torch.no_grad()
def gaussian_pixel_counts(scene: Scene, camera,
                          cfg: RenderConfig) -> np.ndarray:
    """[N] int64: the pixels whose primary ray crosses each Gaussian, the
    inverted attribution map (inverse_integrator.h:125-131), exact."""
    dev, chunks = _chunks(scene, cfg)
    camera = camera.to(dev)
    counts = torch.zeros(scene.medium.n, dtype=torch.int64, device=dev)
    for ids in chunks:
        counts += _primary_hits(scene, camera, cfg, ids)[2].sum(dim=0)
    return counts.cpu().numpy()
