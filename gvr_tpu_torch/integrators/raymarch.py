"""Deterministic single-scatter ray marchers.

Counterpart of ``gvr_tpu/integrators/raymarch.py``:

* ``render_raymarch_gaussians`` (reference ``RayMarchingGaussians``,
  test_integrators.h:143-297): a fixed-step march through the pixel
  centres, the analytic (erf) transmittance of each step, NEE to every
  point light and ``env_samples`` Monte Carlo environment directions, each
  with its analytic shadow transmittance;
* ``render_raymarch_spheres`` (reference ``RayMarchingSpheres``,
  test_integrators.h:11-136): the same march through a sphere mixture,
  with the closed-form piecewise-constant transmittance;
* ``render_pure_raymarch`` (reference ``PureRayMarching``,
  integrator.h:100-267): the medium-agnostic marcher (Gaussians, spheres
  or a voxel grid) with every transmittance *marched*
  (``march_transmittance``), the slow, assumption-free baseline.

A step's light and environment rays go through one batched call of
[B * (L + E), N] arrays, and their sums are taken in the JAX package's
order (lights in index order, then environment samples 0..E-1), so the
batching changes no bit.  The environment directions of a step are drawn
in one K3 launch (``ops/sampling.uniform_planes``), keyed (pixel, step,
env sample).  A march runs from the step before its rays' first medium
entry to their farthest exit below tmax (``_march_range``, one host read;
a voxel grid's one "primitive" is its box); the JAX package runs every
step and masks, which gives the same bits, since a step where no
primitive is active multiplies transmittance by exp(-0) = 1 and adds 0
radiance.
"""

from __future__ import annotations

import math
import time

import numpy as np
import torch

from gvr_tpu_torch.config import RenderConfig
from gvr_tpu_torch.integrators.common import image_chunk, render_chunked
from gvr_tpu_torch.integrators.test_hit import pixel_rays
from gvr_tpu_torch.ops.quadratics import intersect_gaussians
from gvr_tpu_torch.ops.sampling import dir_from_xi, uniform_planes
from gvr_tpu_torch.ops.transmittance import (any_hit, far_bound, tau_coeffs,
                                             transmittance_over_segment,
                                             transmittance_up_to)
from gvr_tpu_torch.scene.gaussians import GaussianMixture
from gvr_tpu_torch.scene.scene import Scene
from gvr_tpu_torch.scene.spheres import SphereMixture

INV_4PI = 1.0 / (4.0 * math.pi)
FOUR_PI = 4.0 * math.pi


def _medium_box(medium):
    """(lo [3], hi [3]) numpy: the box of the medium's primitives (the
    Gaussians' R_CUT AABBs, the spheres' centre +- radius, or the voxel
    grid's AABB)."""
    bmin, bmax = medium.aabbs()
    return (bmin.detach().cpu().numpy().min(axis=0),
            bmax.detach().cpu().numpy().max(axis=0))


def _scene_t_end(scene: Scene, camera) -> float:
    """A bound on the march length from host geometry: the farthest corner
    of the medium's box from the camera position, plus 2 for the image
    plane's offset."""
    bmin, bmax = _medium_box(scene.medium)
    pos = camera.position.detach().cpu().numpy()
    corners = np.array([[bmin[i] if (k >> i) & 1 else bmax[i]
                         for i in range(3)] for k in range(8)])
    return float(np.max(np.linalg.norm(corners - pos, axis=-1))) + 2.0


def _quant_steps(raw: float) -> int:
    """ceil(raw) + 1 rounded up to a multiple of 128, the JAX package's
    step count (steps past the medium are masked, so the count only
    bounds the march)."""
    n = max(1, int(math.ceil(raw)) + 1)
    return ((n + 127) // 128) * 128


def _medium_diag(medium) -> float:
    """The diagonal of the medium's box: the longest chord of any shadow
    or environment ray."""
    lo, hi = _medium_box(medium)
    return float(np.linalg.norm(hi - lo))


def _f32(x: float) -> float:
    """x rounded to float32 (the JAX package's k * step and t + step are
    float32 products and sums)."""
    return float(np.float32(x))


def _step_t(k: int, step: float) -> float:
    return _f32(np.float32(k) * np.float32(step))


def _march_range(t0, t1, hit, tmax, step: float, n_steps: int):
    """(first, last) step of a march of rays whose Gaussians' intervals
    are [t0, t1] where hit ([R, N]), each ray up to tmax [R] or without
    end (None): before the first entry and past the last exit below tmax
    no Gaussian is active.  One host read."""
    if not hit.numel():
        return 0, 0
    t_in = torch.where(hit, t0, torch.inf).amin()
    t_out = torch.where(hit, t1, 0.0).amax(dim=-1)
    if tmax is not None:
        t_out = torch.minimum(tmax, t_out)
    t_in, t_out = torch.stack([t_in, t_out.max()]).tolist()
    first = max(0, int(t_in / step) - 1) if math.isfinite(t_in) else n_steps
    last = min(n_steps, int(math.ceil(t_out / step)) + 1)
    return first, last


def _medium_intervals(medium, o, d):
    """(t0 clamped to >= 0, t1, hit) of every primitive along rays."""
    if isinstance(medium, GaussianMixture):
        t0, t1, hit = intersect_gaussians(medium, o, d)
    else:
        t0, t1, hit = medium.intersect(o, d)
    return torch.clamp(t0, min=0.0), t1, hit


def _medium_sigma(medium, pos, active):
    """(sigma_a, sigma_s) of the medium at pos over an active mask: the
    Gaussians and the voxel grid vary with pos, the spheres are
    homogeneous and need only the mask."""
    if isinstance(medium, SphereMixture):
        return medium.sigma_at(active)
    return medium.sigma_albedo(pos, active)


def _shadow_rays(scene: Scene, cfg: RenderConfig, ids, k: int, pos):
    """(o, d, dist) of a step's shadow rays, [(L + E) * B, 3] and
    [L * B]: the rays to the L point lights, then E environment
    directions keyed (pixel, step k, env sample) from one K3 launch."""
    b = pos.shape[0]
    num_lights, e = scene.lights_p.shape[0], cfg.env_samples
    to_l = scene.lights_p[:, None, :] - pos                  # [L,B,3]
    dist = torch.linalg.vector_norm(to_l, dim=-1)
    dirs = [(to_l / dist[..., None]).reshape(-1, 3)]
    if e:
        xi = uniform_planes(ids.expand(e, b), k,
                            torch.arange(e, dtype=torch.int32,
                                         device=ids.device)[:, None], 2,
                            cfg.seed)                        # [2,E,B]
        dirs.append(dir_from_xi(xi.permute(1, 2, 0)).reshape(-1, 3))
    o = pos.repeat(num_lights + e, 1)
    return o, torch.cat(dirs), dist.reshape(-1)


def _in_scatter(scene: Scene, cfg: RenderConfig, tr, dist, b: int):
    """li + le [B,3] from the transmittances tr [(L + E) * B] of a step's
    shadow rays, summed in the JAX package's order."""
    num_lights, e = scene.lights_p.shape[0], cfg.env_samples
    tr = tr.reshape(num_lights + e, b)
    dist = dist.reshape(num_lights, b)
    li = torch.zeros((b, 3), dtype=torch.float32, device=tr.device)
    for l in range(num_lights):
        li = li + tr[l][:, None] * scene.lights_i[l] \
            / (dist[l] * dist[l])[:, None]
    le = torch.zeros_like(li)
    for j in range(e):
        le = le + tr[num_lights + j][:, None] * scene.env_color
    return li + le / max(e, 1) * FOUR_PI


def _march_gaussians(scene: Scene, camera, cfg: RenderConfig, n_steps: int,
                     counts: dict):
    """The analytic marcher's radiance of a chunk of pixel ids."""
    gmm, step = scene.medium, cfg.step_size

    def radiance(ids):
        o, d = pixel_rays(camera, cfg, ids)
        b = ids.shape[0]
        rg = tau_coeffs(gmm, o, d)
        hit_any = any_hit(rg)
        t_end = far_bound(rg)
        big_t = torch.ones(b, dtype=torch.float32, device=ids.device)
        rad = torch.zeros((b, 3), dtype=torch.float32, device=ids.device)
        for k in range(*_march_range(rg.t0, rg.t1, rg.hit, None, step,
                                     n_steps)):
            t = _step_t(k, step)
            counts["steps"] += 1
            live = (t < t_end) & hit_any
            pos = o + t * d
            active = rg.hit & (rg.t0 <= t) & (t < rg.t1)
            _, sigma_s = gmm.sigma_albedo(pos, active)
            so, sd, dist = _shadow_rays(scene, cfg, ids, k, pos)
            tmax = torch.cat([dist, torch.full((cfg.env_samples * b,), 1e8,
                                               device=ids.device)])
            lsum = _in_scatter(scene, cfg,
                               transmittance_up_to(gmm, so, sd, tmax), dist,
                               b)
            contrib = (big_t * sigma_s)[:, None] * lsum * (step * INV_4PI)
            rad = rad + torch.where(live[:, None], contrib, 0.0)
            big_t = torch.where(
                live, big_t * transmittance_over_segment(
                    rg, t, _f32(np.float32(t) + np.float32(step)), active),
                big_t)
        rad = rad + big_t[:, None] * scene.env_color
        return torch.where(hit_any[:, None], rad, scene.env_color[None, :])

    return radiance


def render_raymarch_gaussians(scene: Scene, camera, cfg: RenderConfig,
                              device="cuda", stats: dict | None = None
                              ) -> np.ndarray:
    """[H, W, 3] float32 on the host: the analytic-transmittance marcher
    (``RayMarchingGaussians``, test_integrators.h:143) with step
    ``cfg.step_size`` and ``cfg.env_samples`` environment directions.
    ``stats``, if given, receives the seconds (host clock, ending with
    the copy to the host), the step bound, the steps marched (summed over
    the chunks), K3's launches (one a step marched), the chunk and the
    chunks."""
    scene.require_gaussian("render_raymarch_gaussians")
    t0 = time.perf_counter()
    scene = scene.to(device)
    camera = camera.to(device)
    n_steps = _quant_steps(_scene_t_end(scene, camera) / cfg.step_size)
    # a step's shadow rays hold [B * (L + E), N] arrays
    rays = max(4, scene.num_lights + cfg.env_samples)
    chunk = image_chunk(cfg, scene.medium.n * rays, device)
    counts = {"steps": 0}
    w, h = cfg.width, cfg.height
    img = render_chunked(_march_gaussians(scene, camera, cfg, n_steps,
                                          counts), w * h, chunk, device)
    out = img.cpu().numpy().reshape(h, w, 3)
    if stats is not None:
        stats.update(integrator="raymarch", seconds=time.perf_counter() - t0,
                     n_steps=n_steps, steps=counts["steps"],
                     k3_launches=counts["steps"] if cfg.env_samples else 0,
                     chunk=chunk, chunks=-(-w * h // chunk),
                     device=str(device))
    return out


def march_transmittance(medium, o, d, tmax, step: float, n_steps: int):
    """Marched (left-Riemann) transmittance T = prod exp(-sigma_t(t_k) dt)
    of rays [R, 3] up to tmax [R] (``PureRayMarching::march_transmittance``,
    integrator.h:105-135), at most n_steps steps, over the steps where a
    Gaussian may be active (``_march_range``)."""
    t0, t1, hit = _medium_intervals(medium, o, d)
    T = torch.ones(o.shape[:-1], dtype=torch.float32, device=o.device)
    for k in range(*_march_range(t0, t1, hit, tmax, step, n_steps)):
        t = _step_t(k, step)
        live = t < tmax
        active = hit & (t0 <= t) & (t < t1)
        sa, ss = _medium_sigma(medium, o + t * d, active)
        T = torch.where(live, T * torch.exp(-(sa + ss) * step), T)
    return T


def _march_pure(scene: Scene, camera, cfg: RenderConfig, n_steps: int,
                shadow_steps: int, counts: dict):
    """The pure marcher's radiance of a chunk of pixel ids."""
    medium, step = scene.medium, cfg.step_size

    def radiance(ids):
        o, d = pixel_rays(camera, cfg, ids)
        b = ids.shape[0]
        t0, t1, hitm = _medium_intervals(medium, o, d)
        hit_any = hitm.any(dim=-1)
        t_end = torch.where(hitm, t1, 0.0).amax(dim=-1)
        big_t = torch.ones(b, dtype=torch.float32, device=ids.device)
        rad = torch.zeros((b, 3), dtype=torch.float32, device=ids.device)
        for k in range(*_march_range(t0, t1, hitm, None, step, n_steps)):
            t = _step_t(k, step)
            counts["steps"] += 1
            live = (t < t_end) & hit_any
            pos = o + t * d
            active = hitm & (t0 <= t) & (t < t1)
            sa, ss = _medium_sigma(medium, pos, active)
            so, sd, dist = _shadow_rays(scene, cfg, ids, k, pos)
            # an environment ray's march ends at its own medium exit
            n_l = dist.shape[0]
            _, et1, ehit = _medium_intervals(medium, so[n_l:], sd[n_l:])
            tmax = torch.cat([dist, torch.where(ehit, et1, 0.0)
                              .amax(dim=-1)])
            tr = march_transmittance(medium, so, sd, tmax, step,
                                     shadow_steps)
            lsum = _in_scatter(scene, cfg, tr, dist, b)
            contrib = (big_t * ss)[:, None] * lsum * (step * INV_4PI)
            rad = rad + torch.where(live[:, None], contrib, 0.0)
            big_t = torch.where(live, big_t * torch.exp(-(sa + ss) * step),
                                big_t)
        rad = rad + big_t[:, None] * scene.env_color
        return torch.where(hit_any[:, None], rad, scene.env_color[None, :])

    return radiance


def _scene_t_end_any(scene: Scene, camera, cfg: RenderConfig,
                     device) -> float:
    """The farthest medium exit of any pixel-centre ray of the image."""
    def t_end(ids):
        o, d = pixel_rays(camera, cfg, ids)
        _, t1, hitm = _medium_intervals(scene.medium, o, d)
        return torch.where(hitm, t1, 0.0).amax(dim=-1)[:, None].expand(-1, 3)

    chunk = image_chunk(cfg, scene.medium.n, device)
    return float(render_chunked(t_end, cfg.width * cfg.height, chunk,
                                device)[:, 0].max())


def render_pure_raymarch(scene: Scene, camera, cfg: RenderConfig,
                         device="cuda", stats: dict | None = None
                         ) -> np.ndarray:
    """[H, W, 3] float32 on the host: the single-scatter marcher with
    marched shadow and environment transmittance (``PureRayMarching``,
    integrator.h:100-267), O(steps x (lights + env_samples) x shadow
    steps) a pixel.  ``stats`` as ``render_raymarch_gaussians``'s, with
    the shadow-march bound.  The medium may be any of the three."""
    t0 = time.perf_counter()
    scene = scene.to(device)
    camera = camera.to(device)
    step = cfg.step_size
    n_steps = max(1, int(math.ceil(
        _scene_t_end_any(scene, camera, cfg, device) / step)) + 1)
    # a shadow ray can cross the medium's whole diagonal, which the
    # camera's bound may not cover
    shadow_steps = max(n_steps, int(math.ceil(
        _medium_diag(scene.medium) / step))) + 8
    rays = max(8, scene.num_lights + cfg.env_samples)
    chunk = image_chunk(cfg, scene.medium.n * rays, device)
    counts = {"steps": 0}
    w, h = cfg.width, cfg.height
    img = render_chunked(_march_pure(scene, camera, cfg, n_steps,
                                     shadow_steps, counts), w * h, chunk,
                         device)
    out = img.cpu().numpy().reshape(h, w, 3)
    if stats is not None:
        stats.update(integrator="pureraymarch",
                     seconds=time.perf_counter() - t0, n_steps=n_steps,
                     shadow_steps=shadow_steps, steps=counts["steps"],
                     k3_launches=counts["steps"] if cfg.env_samples else 0,
                     chunk=chunk, chunks=-(-w * h // chunk),
                     device=str(device))
    return out


def _march_spheres(scene: Scene, camera, cfg: RenderConfig, n_steps: int,
                   counts: dict):
    """The sphere marcher's radiance of a chunk of pixel ids."""
    smm, step = scene.medium, cfg.step_size

    def radiance(ids):
        o, d = pixel_rays(camera, cfg, ids)
        b = ids.shape[0]
        t0, t1, hitm = _medium_intervals(smm, o, d)
        hit_any = hitm.any(dim=-1)
        t_end = torch.where(hitm, t1, 0.0).amax(dim=-1)
        big_t = torch.ones(b, dtype=torch.float32, device=ids.device)
        rad = torch.zeros((b, 3), dtype=torch.float32, device=ids.device)
        for k in range(*_march_range(t0, t1, hitm, None, step, n_steps)):
            t = _step_t(k, step)
            counts["steps"] += 1
            live = (t < t_end) & hit_any
            active = hitm & (t0 <= t) & (t < t1)
            sigma_a, sigma_s = smm.sigma_at(active)
            so, sd, dist = _shadow_rays(scene, cfg, ids, k, o + t * d)
            tmax = torch.cat([dist, torch.full((cfg.env_samples * b,), 1e8,
                                               device=ids.device)])
            lsum = _in_scatter(scene, cfg,
                               smm.transmittance_up_to(so, sd, tmax), dist,
                               b)
            contrib = (big_t * sigma_s)[:, None] * lsum * (step * INV_4PI)
            rad = rad + torch.where(live[:, None], contrib, 0.0)
            big_t = torch.where(
                live, big_t * torch.exp(-(sigma_a + sigma_s) * step), big_t)
        rad = rad + big_t[:, None] * scene.env_color
        return torch.where(hit_any[:, None], rad, scene.env_color[None, :])

    return radiance


def render_raymarch_spheres(scene: Scene, camera, cfg: RenderConfig,
                            device="cuda", stats: dict | None = None
                            ) -> np.ndarray:
    """[H, W, 3] float32 on the host: the sphere marcher with the
    closed-form piecewise-constant transmittance (``RayMarchingSpheres``,
    test_integrators.h:11-136) at step ``cfg.step_size`` with
    ``cfg.env_samples`` environment directions.  ``stats`` as
    ``render_raymarch_gaussians``'s."""
    if not isinstance(scene.medium, SphereMixture):
        raise TypeError(f"render_raymarch_spheres renders a SphereMixture, "
                        f"not a {type(scene.medium).__name__}")
    t0 = time.perf_counter()
    scene = scene.to(device)
    camera = camera.to(device)
    n_steps = _quant_steps(_scene_t_end(scene, camera) / cfg.step_size)
    rays = max(4, scene.num_lights + cfg.env_samples)
    chunk = image_chunk(cfg, scene.medium.n * rays, device)
    counts = {"steps": 0}
    w, h = cfg.width, cfg.height
    img = render_chunked(_march_spheres(scene, camera, cfg, n_steps, counts),
                         w * h, chunk, device)
    out = img.cpu().numpy().reshape(h, w, 3)
    if stats is not None:
        stats.update(integrator="raymarch", seconds=time.perf_counter() - t0,
                     n_steps=n_steps, steps=counts["steps"],
                     k3_launches=counts["steps"] if cfg.env_samples else 0,
                     chunk=chunk, chunks=-(-w * h // chunk),
                     device=str(device))
    return out
