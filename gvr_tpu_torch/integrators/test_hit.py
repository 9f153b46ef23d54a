"""Hit-mask integrator, the first smoke test.

Counterpart of ``gvr_tpu/integrators/test_hit.py`` (reference
``TestIntegrator``, integrator.h:65-94): magenta where the primary ray
through the pixel centre crosses any primitive of the medium (a
Gaussian's R_CUT-sigma ellipsoid, a sphere, or a voxel grid's box), the
environment colour elsewhere.  It draws no random number.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from gvr_tpu_torch.config import RenderConfig
from gvr_tpu_torch.integrators.common import (ids_to_pixels, image_chunk,
                                              render_chunked)
from gvr_tpu_torch.ops.quadratics import intersect_gaussians
from gvr_tpu_torch.scene.gaussians import GaussianMixture
from gvr_tpu_torch.scene.scene import Scene

MAGENTA = (1.0, 0.0, 1.0)


def pixel_rays(camera, cfg: RenderConfig, ids: torch.Tensor):
    """(o, d) of the rays through the centres of pixel ids [B]."""
    x, y = ids_to_pixels(ids, cfg.width)
    u = (x.to(torch.float32) + 0.5) / cfg.width
    v = (y.to(torch.float32) + 0.5) / cfg.height
    return camera.sample_ray(torch.stack([u, v], dim=-1))


def render_hit_mask(scene: Scene, camera, cfg: RenderConfig, device="cuda",
                    stats: dict | None = None) -> np.ndarray:
    """[H, W, 3] float32 on the host.  ``stats``, if given, receives the
    seconds (host clock, ending with the copy to the host) and the
    chunk."""
    t0 = time.perf_counter()
    scene = scene.to(device)
    camera = camera.to(device)
    magenta = torch.tensor(MAGENTA, dtype=torch.float32, device=device)

    def radiance(ids):
        o, d = pixel_rays(camera, cfg, ids)
        if isinstance(scene.medium, GaussianMixture):
            _, _, hit = intersect_gaussians(scene.medium, o, d)
        else:
            _, _, hit = scene.medium.intersect(o, d)
        return torch.where(hit.any(dim=-1)[:, None], magenta,
                           scene.env_color)

    chunk = image_chunk(cfg, scene.medium.n, device)
    img = render_chunked(radiance, cfg.width * cfg.height, chunk, device)
    out = img.cpu().numpy().reshape(cfg.height, cfg.width, 3)
    if stats is not None:
        stats.update(integrator="hitmask", seconds=time.perf_counter() - t0,
                     chunk=chunk, device=str(device))
    return out
