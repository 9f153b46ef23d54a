"""Single-scatter free-flight Monte Carlo integrator.

Counterpart of ``gvr_tpu/integrators/freeflight.py`` (reference
``FreeFlightGaussians``, integrator.h:273-409): stratified pixel samples,
one free-flight distance a path by any solver, NEE to one of (lights +
env), no recursion: the first bounce of the multi-scatter tracer, in
plain PyTorch over [rays, N] arrays, with ``candidate_k``.  Each (chunk,
sample) draws its jitter pair and its nine bounce uniforms through K3
(``ops/sampling.uniform_planes``, two launches).
"""

from __future__ import annotations

import time

import numpy as np
import torch

from gvr_tpu_torch.config import RenderConfig
from gvr_tpu_torch.integrators.common import image_chunk
from gvr_tpu_torch.integrators.multiscatter import (INV_4PI, _xla_bounce,
                                                    mc_camera_rays)
from gvr_tpu_torch.kernels.rng import BOUNCE_DRAWS
from gvr_tpu_torch.ops.sampling import uniform_planes
from gvr_tpu_torch.scene.scene import Scene


def single_scatter_radiance(scene: Scene, origin, direction, rng_ids,
                            cfg: RenderConfig, sample=0) -> torch.Tensor:
    """Radiance [B,3] of rays [B,3] that scatter once: the NEE term at the
    sampled free-flight point, or the environment where the ray escapes,
    with the bounce-0 draws of (rng_ids, sample)."""
    xi = uniform_planes(rng_ids, sample, 0, BOUNCE_DRAWS, cfg.seed)
    _, scattered, albedo, li, w_ne = _xla_bounce(scene, cfg, origin,
                                                 direction, xi[:5].T, xi[8])
    scatter_l = (albedo * INV_4PI * w_ne)[:, None] * li
    return torch.where(scattered[:, None], scatter_l,
                       scene.env_color.expand_as(scatter_l))


def render_single_scatter(scene: Scene, camera, cfg: RenderConfig,
                          device="cuda", stats: dict | None = None
                          ) -> np.ndarray:
    """[H, W, 3] float32 on the host: spp stratified samples a pixel, the
    pixels in scanline chunks within the element budget (the last padded
    with repeats), summed sample by sample as the JAX package sums them.
    ``stats``, if given, receives the seconds (host clock, ending with the
    copy to the host), paths, the chunk and K3's launches."""
    scene.require_gaussian("render_single_scatter")
    t0 = time.perf_counter()
    scene = scene.to(device)
    camera = camera.to(device)
    w, h = cfg.width, cfg.height
    chunk = image_chunk(cfg, scene.medium.n, device)
    acc = torch.zeros((w * h, 3), dtype=torch.float32, device=device)
    launches = 0
    for si in range(cfg.spp):
        for start in range(0, w * h, chunk):
            ids = torch.clamp(torch.arange(start, start + chunk,
                                           dtype=torch.int32, device=device),
                              max=w * h - 1)
            o, d, _ = mc_camera_rays(scene, camera, cfg, ids, si)
            vals = single_scatter_radiance(scene, o, d, ids, cfg, si)
            launches += 2
            stop = min(start + chunk, w * h)
            acc[start:stop] += vals[: stop - start]
    out = (acc / cfg.spp).cpu().numpy().reshape(h, w, 3)
    if stats is not None:
        stats.update(integrator="singlescatter",
                     seconds=time.perf_counter() - t0, paths=w * h * cfg.spp,
                     chunk=chunk, k3_launches=launches, device=str(device))
    return out
