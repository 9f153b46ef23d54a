"""Multi-scatter Monte Carlo volumetric path tracer: the main path.

Counterpart of ``gvr_tpu/integrators/multiscatter.py`` (reference
``MultiScatterGaussians``, integrator.h:417-720): per path, free-flight
sampling by regular tracking, NEE to one of (lights + env) per bounce, an
isotropic phase, throughput *= albedo, and Russian roulette after
``min_scatter`` bounces.

``render_multiscatter`` walks the pixels in 16x8 screen tiles, in chunks,
keeps every result on the device and copies the image to the host once at
the end.  ``engine_for`` picks the engine as the JAX package does: the
dense megakernel (one ``kernels/megatrace.mega_call`` launch per chunk of
``pick_chunk`` pixels) up to GRID_MIN_N Gaussians, the pooled grid
wavefront (``integrators/gridscatter``, chunks of at most 2^15 pixels)
above.  A scene that the JAX package would send to the big-N dense engine
raises.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from gvr_tpu_torch.accel import grid as accel_grid
from gvr_tpu_torch.cameras import PinholeCamera
from gvr_tpu_torch.config import RenderConfig
from gvr_tpu_torch.integrators.common import pick_chunk
from gvr_tpu_torch.integrators.gridscatter import (
    grid_for, wavefront_pixels_grid_pooled)
from gvr_tpu_torch.kernels.megatrace import (camera_vector, mega_call,
                                             strat_n, strat_uv)
from gvr_tpu_torch.kernels.pathtrace import MEGA_MAX_GAUSSIANS, pack_table
from gvr_tpu_torch.scene.scene import Scene

__all__ = ["GRID_CHUNK", "GRID_MIN_N", "engine_for", "render_multiscatter",
           "strat_n", "strat_uv", "tile_order", "wavefront_pixels"]

# The JAX package's threshold: above it engine='auto' takes the grid engine.
GRID_MIN_N = 2000
# Pixels per grid-wavefront chunk at most (gvr_tpu's multiscatter.py:735).
GRID_CHUNK = 1 << 15


def engine_for(cfg: RenderConfig, gmm) -> str:
    """'grid' or 'dense' as the JAX package resolves it
    (``gvr_tpu/integrators/multiscatter.py:644-689``): the grid for
    engine='grid' and for 'auto' above GRID_MIN_N Gaussians, unless the
    grid's densest cell spans more than S_CAP_MAX slices, which sends
    'auto' to the dense engine and refuses 'grid'.  Building the grid is
    part of the decision (``grid_for`` keeps it for the render).  The
    dense engine raises above MEGA_MAX_GAUSSIANS: its big-N kernels wait
    for their port."""
    if cfg.engine == "grid" or (cfg.engine == "auto"
                                and gmm.n > GRID_MIN_N):
        s_cap = grid_for(gmm).s_cap
        if s_cap <= accel_grid.S_CAP_MAX:
            return "grid"
        if cfg.engine == "grid":
            raise ValueError(
                f"engine='grid': the scene's densest cell spans {s_cap} "
                f"slices (> S_CAP_MAX={accel_grid.S_CAP_MAX}), which the "
                f"JAX package refuses too; use engine='auto' or 'dense'")
    if gmm.n > MEGA_MAX_GAUSSIANS:
        raise NotImplementedError(
            f"{gmm.n} Gaussians > MEGA_MAX_GAUSSIANS={MEGA_MAX_GAUSSIANS}: "
            f"the big-N dense engine is not ported yet (ROADMAP Queue 2, "
            f"kernels K4/K5)")
    return "dense"


def tile_order(w: int, h: int, tw: int = 16, th: int = 8) -> np.ndarray:
    """Pixel ids permuted into tw x th screen tiles, so each 128-pixel
    kernel block covers one spatially coherent tile."""
    ys, xs = np.mgrid[0:h, 0:w]
    key = ((ys // th).astype(np.int64) * ((w + tw - 1) // tw)
           + (xs // tw)) * (tw * th) \
        + (ys % th) * tw + (xs % tw)
    return np.argsort(key.reshape(-1), kind="stable").astype(np.int32)


def _mega_inputs(scene: Scene, camera):
    """(camera vector, table, lights, env, pinhole) for mega_call."""
    return (camera_vector(camera), pack_table(scene.medium), scene.lights(),
            scene.env_color, isinstance(camera, PinholeCamera))


def wavefront_pixels(scene: Scene, camera, cfg: RenderConfig,
                     ids: torch.Tensor) -> torch.Tensor:
    """Mean radiance [B,3] over the spp samples of each pixel id [B]
    (int32, on the scene's device), through the megakernel."""
    cam, table, lights, env, pinhole = _mega_inputs(scene, camera)
    return mega_call(cam, table, ids, cfg, lights, env, pinhole)[0] / cfg.spp


def render_multiscatter(scene: Scene, camera, cfg: RenderConfig,
                        device="cuda", progress: bool = False,
                        stats: dict | None = None) -> np.ndarray:
    """Full MC render on ``device``: [H, W, 3] float32 on the host.

    Results are scattered into a device image that is copied to the host
    once (the megakernel's launches are asynchronous; the grid wavefront
    reads one flag per iteration).  ``progress`` prints the pixels done
    after each chunk.  ``stats``, if given, receives the engine, the
    render's seconds (host clock, after the engine choice and grid build,
    ending with the copy to the host), the seconds of the engine choice
    with the grid build (``grid_seconds``; a cached grid costs only its
    content hash), paths, bounce evaluations (extension rays traced, on
    the grid), chunks, grid iterations and Gaussian count."""
    t_build = time.perf_counter()
    engine = engine_for(cfg, scene.medium)
    grid = grid_for(scene.medium) if engine == "grid" else None
    t0 = time.perf_counter()
    scene = scene.to(device)
    camera = camera.to(device)
    w, h = cfg.width, cfg.height
    order = torch.from_numpy(tile_order(w, h)).to(device)
    img = torch.zeros((w * h, 3), dtype=torch.float32, device=device)
    evals = torch.zeros((), dtype=torch.int64, device=device)
    n_chunks = iterations = 0
    if grid is None:
        cam, table, lights, env, pinhole = _mega_inputs(scene, camera)
        chunk = pick_chunk(cfg, scene.medium.n, device)
    else:
        grid = grid.to(device)
        chunk = min(cfg.ray_chunk, GRID_CHUNK)
    chunk = min(chunk, ((w * h + 255) // 256) * 256)
    for start in range(0, w * h, chunk):
        ids = order[start:start + chunk]
        if grid is None:
            sums, counts = mega_call(cam, table, ids, cfg, lights, env,
                                     pinhole)
            img[ids] = sums / cfg.spp
            if stats is not None:
                evals += counts.sum()
        else:
            st = {}
            img[ids] = wavefront_pixels_grid_pooled(scene, grid, camera, cfg,
                                                    ids, st)
            evals += st["ext_rays"]
            iterations += st["iterations"]
        n_chunks += 1
        if progress:
            print(f"  pixels {min(start + chunk, w * h)}/{w * h}")
    out = img.cpu().numpy().reshape(h, w, 3)
    if stats is not None:
        stats.update(engine=engine, seconds=time.perf_counter() - t0,
                     grid_seconds=t0 - t_build,
                     paths=w * h * cfg.spp, bounce_evals=int(evals),
                     chunks=n_chunks, iterations=iterations,
                     n=scene.medium.n, device=str(device))
    return out
