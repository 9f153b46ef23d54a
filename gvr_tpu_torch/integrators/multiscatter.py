"""Multi-scatter Monte Carlo volumetric path tracer: the main path.

Counterpart of ``gvr_tpu/integrators/multiscatter.py`` (reference
``MultiScatterGaussians``, integrator.h:417-720): per path, free-flight
sampling by regular tracking, NEE to one of (lights + env) per bounce, an
isotropic phase, throughput *= albedo, and Russian roulette after
``min_scatter`` bounces.

``render_multiscatter`` walks the pixels in 16x8 screen tiles, one chunk of
``pick_chunk`` pixels per megakernel launch (``kernels/megatrace.mega_call``),
keeps every launch on the device and copies the image to the host once at
the end.  Only the dense engine exists: a scene that the JAX package would
send to the grid or big-N engine raises.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from gvr_tpu_torch.cameras import PinholeCamera
from gvr_tpu_torch.config import RenderConfig
from gvr_tpu_torch.integrators.common import pick_chunk
from gvr_tpu_torch.kernels.megatrace import (camera_vector, mega_call,
                                             strat_n, strat_uv)
from gvr_tpu_torch.kernels.pathtrace import MEGA_MAX_GAUSSIANS, pack_table
from gvr_tpu_torch.scene.scene import Scene

__all__ = ["GRID_MIN_N", "engine_for", "render_multiscatter", "strat_n",
           "strat_uv", "tile_order", "wavefront_pixels"]

# The JAX package's threshold: above it engine='auto' takes the grid engine.
GRID_MIN_N = 2000


def engine_for(cfg: RenderConfig, gmm) -> str:
    """'dense' where the JAX package takes a dense engine that this package
    has (the megakernel); raise where it would take one that waits."""
    if cfg.engine == "auto" and gmm.n > GRID_MIN_N:
        raise NotImplementedError(
            f"{gmm.n} Gaussians > GRID_MIN_N={GRID_MIN_N}: the grid engine "
            f"is not ported yet (ROADMAP Queue 1, accel/grid + "
            f"gridscatter, with kernels K6/K7)")
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

    Each chunk launch is asynchronous; results are scattered into a device
    image that is copied to the host once.  ``progress`` prints the pixels
    enqueued after each chunk.  ``stats``, if given, receives the render's
    seconds (host clock, ending with the copy to the host), paths, bounce
    evaluations, chunks and Gaussian count."""
    engine_for(cfg, scene.medium)
    t0 = time.perf_counter()
    scene = scene.to(device)
    camera = camera.to(device)
    cam, table, lights, env, pinhole = _mega_inputs(scene, camera)
    w, h = cfg.width, cfg.height
    order = torch.from_numpy(tile_order(w, h)).to(device)
    chunk = min(pick_chunk(cfg, scene.medium.n, device),
                ((w * h + 255) // 256) * 256)
    img = torch.zeros((w * h, 3), dtype=torch.float32, device=device)
    evals = torch.zeros((), dtype=torch.int64, device=device)
    n_chunks = 0
    for start in range(0, w * h, chunk):
        ids = order[start:start + chunk]
        sums, counts = mega_call(cam, table, ids, cfg, lights, env, pinhole)
        img[ids] = sums / cfg.spp
        n_chunks += 1
        if stats is not None:
            evals += counts.sum()
        if progress:
            print(f"  pixels {min(start + chunk, w * h)}/{w * h}")
    out = img.cpu().numpy().reshape(h, w, 3)
    if stats is not None:
        stats.update(seconds=time.perf_counter() - t0, paths=w * h * cfg.spp,
                     bounce_evals=int(evals), chunks=n_chunks,
                     n=scene.medium.n, device=str(device))
    return out
