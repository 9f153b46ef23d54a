"""Throughput helpers (``gvr_tpu/utils/profiling.py:52-149``).

``path_statistics`` traces a subsample of pixel-centre paths with the
multiscatter estimator's survival rules and counts their rays and
scatter events, the bounce histogram behind ``bench.py``'s Mrays/s.
``device_trace`` (the CLI's ``--trace``) and ``RenderStats`` wait for
their port (ROADMAP Queue 1, tooling).
"""

from __future__ import annotations

import numpy as np
import torch

from gvr_tpu_torch.config import RenderConfig, Solver
from gvr_tpu_torch.integrators.multiscatter import _roulette
from gvr_tpu_torch.integrators.test_hit import pixel_rays
from gvr_tpu_torch.kernels.rng import BOUNCE_DRAWS
from gvr_tpu_torch.ops.sampling import dir_from_xi, uniform_planes
from gvr_tpu_torch.ops.solvers import sample_free_flight
from gvr_tpu_torch.ops.transmittance import albedo_at_from_rg, tau_coeffs


def mrays_per_sec(n_rays: int, seconds: float) -> float:
    return n_rays / max(seconds, 1e-9) / 1e6


def path_statistics(scene, camera, cfg: RenderConfig,
                    sample_pixels: int = 16384, device="cuda") -> dict:
    """{'rays_per_path', 'mean_scatter_events'} over at most
    ``sample_pixels`` pixel-centre paths spread over the image (sample 0):
    each bounce adds a ray for every live path and a shadow ray for each
    one that scatters; the throughput decays by the albedo and Russian
    roulette ends paths as in the wavefront.  The count holds [n, N]
    arrays, so n is capped by an element budget."""
    scene = scene.to(device)
    camera = camera.to(device)
    gmm = scene.medium
    budget = max(256, (3 << 25) // max(gmm.n, 1))
    n = min(sample_pixels, budget, cfg.width * cfg.height)
    ids = torch.from_numpy(np.linspace(0, cfg.width * cfg.height - 1, n,
                                       dtype=np.int32)).to(device)
    o, d = pixel_rays(camera, cfg, ids)
    thr = torch.ones((n, 3), dtype=torch.float32, device=device)
    alive = torch.ones(n, dtype=torch.bool, device=device)
    rays = bounces = 0
    for bounce in range(cfg.max_bounces):
        if not bool(alive.any()):
            break
        rg = tau_coeffs(gmm, o, d)
        xi = uniform_planes(ids, 0, bounce, BOUNCE_DRAWS, cfg.seed)
        target = -torch.log(torch.clamp(1.0 - xi[0], min=1e-12))
        t_sc, scattered = sample_free_flight(
            rg, target, cfg.solver, cfg.solver_iters,
            xi[8] if cfg.solver == Solver.UNIFORM else None,
            finisher=cfg.solver_finisher)
        hits = alive & scattered
        rays += int(alive.sum()) + int(hits.sum())
        bounces += int(hits.sum())
        t_pos = torch.clamp(t_sc, min=0.0)
        albedo = albedo_at_from_rg(rg, gmm.albedo, t_pos)
        thr_n, killed = _roulette(cfg, thr, albedo, bounce, xi[5])
        alive = hits & ~killed
        thr = torch.where(alive[:, None], thr_n, thr)
        o = o + t_pos[:, None] * d
        d = dir_from_xi(xi[6:8].T)
    return {"rays_per_path": rays / n, "mean_scatter_events": bounces / n}
