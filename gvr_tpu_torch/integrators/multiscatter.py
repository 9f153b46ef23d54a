"""Multi-scatter Monte Carlo volumetric path tracer: the main path.

Counterpart of ``gvr_tpu/integrators/multiscatter.py`` (reference
``MultiScatterGaussians``, integrator.h:417-720): per path, free-flight
sampling by regular tracking, NEE to one of (lights + env) per bounce, an
isotropic phase, throughput *= albedo, and Russian roulette after
``min_scatter`` bounces.

``render_multiscatter`` walks the pixels in 16x8 screen tiles, in chunks,
keeps every result on the device and copies the image to the host once at
the end.  ``render_path`` picks its path, and the path's entry in
``_PATHS`` builds the path's inputs once and renders each chunk.
``engine_for`` picks the engine as the JAX package does: the dense engine
up to GRID_MIN_N Gaussians, the pooled grid wavefront
(``integrators/gridscatter``, chunks of at most 2^15 pixels) above, and
the dense engine again where the grid's densest cell spans more than
S_CAP_MAX slices.  The dense engine runs the megakernel (one
``kernels/megatrace.mega_call`` launch per chunk of ``pick_chunk``
pixels) up to MEGA_MAX_GAUSSIANS Gaussians and the big-N wavefront
(``wavefront_pixels_big``: K4 and K5 of ``kernels/pathtrace_big`` each
iteration, its live lanes and their count kept on the device) above, up
to 96 chunks of 256 Gaussians.  With
``cfg.wavefront='step'`` it runs the step wavefront instead
(``wavefront_pixels_step``: the fused bounce kernel K2 of
``kernels/pathtrace`` each iteration) up to MAX_PALLAS_GAUSSIANS, and the
big-N wavefront above, as the JAX package does (``dense_kernel``).

The kernels implement the (analytic-)Newton solver only.  The other
solvers (BISECTION, ANALYTIC_BISECTION, UNIFORM) take the dense XLA
engine at any N, as in the JAX package on its accelerator:
``wavefront_pixels_xla``, the same wavefront with each bounce in plain
PyTorch (``ops/transmittance``, ``ops/solvers``, ``_nee``) over
[rays, N] arrays, its chunk kept within the element budget.  Only it
applies ``candidate_k``.  ``multiscatter_radiance`` is the per-path loop
of the same bounce.  ``multiscatter_radiance_diff`` is the differentiable
estimator of the inverse renderer (``inverse/fit``), plain PyTorch under
autograd.  Every draw on the card comes from K3 (``kernels/rng``).  In a
``torch.distributed`` job ``render_multiscatter`` shards each chunk over
the ranks (``parallel/sharding``).
"""

from __future__ import annotations

import collections
import functools
import time

import numpy as np
import torch
import torch.distributed as dist

from gvr_tpu_torch.accel import grid as accel_grid
from gvr_tpu_torch.cameras import PinholeCamera
from gvr_tpu_torch.config import KERNEL_SOLVERS, RenderConfig, Solver
from gvr_tpu_torch.integrators.common import ids_to_pixels, pick_chunk
from gvr_tpu_torch.integrators.gridscatter import (
    grid_for, wavefront_pixels_grid_pooled)
from gvr_tpu_torch.kernels.megatrace import (INV_4PI, camera_vector,
                                             mega_call, strat_n, strat_uv)
from gvr_tpu_torch.kernels.pathtrace import (FOUR_PI, MAX_PALLAS_GAUSSIANS,
                                             MEGA_MAX_GAUSSIANS, bounce_step,
                                             pack_table, padded_n)
from gvr_tpu_torch.kernels.pathtrace_big import (bind_big_nee,
                                                 bind_big_stage1,
                                                 bounce_step_big,
                                                 chunk_boxes, n_chunks_for,
                                                 pack_rows, plan)
from gvr_tpu_torch.kernels.rng import BOUNCE_DRAWS, JITTER_TAG
from gvr_tpu_torch.kernels.wavefront import (bind_wave_post, bind_wave_pre,
                                             lanes, roulette, wave_post,
                                             wave_post_reference, wave_pre,
                                             wave_pre_reference)
from gvr_tpu_torch.ops.sampling import dir_from_xi, uniform_planes
from gvr_tpu_torch.ops.solvers import (sample_free_flight,
                                       solve_conditional_free_flight)
from gvr_tpu_torch.ops.transmittance import (albedo_at_from_rg,
                                             compact_candidates, tau_coeffs,
                                             tau_total, transmittance_up_to)
from gvr_tpu_torch.parallel.sharding import (RAY_AXIS, Mesh, make_mesh,
                                             shard_bounds)
from gvr_tpu_torch.scene.scene import Scene
from gvr_tpu_torch.utils import profiling

__all__ = ["GRID_CHUNK", "GRID_MIN_N", "dense_kernel", "diff_uniforms",
           "engine_for", "mc_camera_rays", "multiscatter_radiance",
           "multiscatter_radiance_diff", "render_multiscatter",
           "render_path", "strat_n", "strat_uv", "tile_ids",
           "wavefront_pixels", "wavefront_pixels_big",
           "wavefront_pixels_step", "wavefront_pixels_xla"]

# The JAX package's threshold: above it engine='auto' takes the grid engine.
GRID_MIN_N = 2000
# Pixels per grid-wavefront chunk at most (gvr_tpu's multiscatter.py:735).
GRID_CHUNK = 1 << 15


def engine_for(cfg: RenderConfig, gmm) -> str:
    """'grid', 'dense' or 'xla' as the JAX package resolves it on its
    accelerator (``gvr_tpu/integrators/multiscatter.py:452-465,
    644-689``).  A solver the kernels do not implement (not NEWTON or
    ANALYTIC_NEWTON) takes the dense XLA engine ('xla') under 'auto' and
    'dense' at any N, and is refused under 'grid'.  Otherwise the grid
    for engine='grid' and for 'auto' above GRID_MIN_N Gaussians, unless
    the grid's densest cell spans more than S_CAP_MAX slices, which sends
    'auto' to the dense engine and refuses 'grid'.  Building the grid is
    part of the decision (``grid_for`` keeps it for the render).  The
    dense engine refuses scenes above the big-N kernels' 96 chunks of 256
    Gaussians with ``plan``'s ValueError, as the JAX package does."""
    if cfg.solver not in KERNEL_SOLVERS:
        if cfg.engine == "grid":
            raise ValueError(
                f"engine='grid' implements the (analytic-)Newton solver "
                f"only; solver={cfg.solver.name} requires engine='dense' "
                f"or 'auto'")
        return "xla"
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
    plan(n_chunks_for(gmm.n))
    return "dense"


def dense_kernel(cfg: RenderConfig, n: int) -> str:
    """The dense engine's kernel path for n Gaussians, as the JAX package
    picks it (``gvr_tpu/integrators/multiscatter.py:488-503``): under
    ``wavefront='step'`` the step wavefront ('step', K2 once an iteration)
    while the padded table holds at most MAX_PALLAS_GAUSSIANS rows, else
    the big-N wavefront ('big'); under 'mega' the megakernel ('mega') up
    to MEGA_MAX_GAUSSIANS, else 'big'."""
    if cfg.wavefront == "step":
        return "step" if padded_n(n) <= MAX_PALLAS_GAUSSIANS else "big"
    return "mega" if n <= MEGA_MAX_GAUSSIANS else "big"


def render_path(cfg: RenderConfig, gmm) -> str:
    """The path ``render_multiscatter`` takes for the mixture ``gmm``:
    'grid' or 'xla' where ``engine_for`` resolves that engine, else the
    dense engine's kernel path by ``dense_kernel``: 'mega', 'step' or
    'big'.  The only place that combines the two."""
    engine = engine_for(cfg, gmm)
    return dense_kernel(cfg, gmm.n) if engine == "dense" else engine


def tile_ids(w: int, h: int, device, tw: int = 16,
             th: int = 8) -> torch.Tensor:
    """Pixel ids [w*h] (int32, on ``device``) permuted into tw x th screen
    tiles, so each 128-pixel kernel block covers one spatially coherent
    tile: the JAX package's ``tile_order``, made without a sort.  Tiles
    run row-major over the tile grid and pixels row-major inside each
    tile, so each band of th rows (the last one shorter where th does not
    divide h) is its full tiles, then its partial tile on the right.
    Each of these at most four blocks of equal tiles is a strided view of
    the row-major pixel ids, copied into the slice of the order it fills:
    one arange and at most four copies, whatever the size."""
    n = w * h
    assert n < 2 ** 31, (w, h)
    ids = torch.arange(n, dtype=torch.int32, device=device).view(h, w)
    out = torch.empty(n, dtype=torch.int32, device=device)
    fy, fx = h - h % th, w - w % tw    # the rows and columns of full tiles
    for y0, y1 in ((0, fy), (fy, h)):
        b = min(th, y1 - y0)           # the band's height
        if b == 0:
            continue
        nb = (y1 - y0) // b
        src = ids[y0:y1].view(nb, b, w)
        dst = out[y0 * w:y1 * w].view(nb, b * w)
        if fx:
            dst[:, :b * fx].view(nb, fx // tw, b, tw).copy_(
                src[:, :, :fx].view(nb, b, fx // tw, tw)
                .permute(0, 2, 1, 3))
        if fx < w:
            dst[:, b * fx:].view(nb, b, w - fx).copy_(src[:, :, fx:])
    return out


def wavefront_pixels(scene: Scene, camera, cfg: RenderConfig,
                     ids: torch.Tensor) -> torch.Tensor:
    """Mean radiance [B,3] over the spp samples of each pixel id [B]
    (int32, on the scene's device) through the dense engine's kernel path
    that ``dense_kernel`` picks: the megakernel, the step wavefront or the
    big-N one, as the JAX package's ``wavefront_pixels`` follows
    ``cfg.wavefront``."""
    return _pixels(dense_kernel(cfg, scene.medium.n), scene, camera, cfg,
                   ids)


def _nee(scene: Scene, gmm, pos, xi_choice, xi_light, xi_env2):
    """(Li [B,3], weight L+1): next-event estimation to one of the L point
    lights or the environment, each with probability 1/(L+1)
    (integrator.h:657-683), through one closed-form shadow-ray
    transmittance; Li holds the env branch's 4 pi."""
    num_lights = scene.lights_p.shape[0]
    wi_env = dir_from_xi(xi_env2)
    if num_lights == 0:
        tr = transmittance_up_to(gmm, pos, wi_env, 1e8)
        return tr[:, None] * scene.env_color * FOUR_PI, 1.0
    is_env = xi_choice < 1.0 / (num_lights + 1)
    lidx = torch.clamp((xi_light * num_lights).to(torch.int64), 0,
                       num_lights - 1)
    to_l = scene.lights_p[lidx] - pos
    dist = torch.linalg.vector_norm(to_l, dim=-1)
    wi_l = to_l / torch.clamp(dist, min=1e-12)[:, None]
    wi = torch.where(is_env[:, None], wi_env, wi_l)
    tr = transmittance_up_to(gmm, pos, wi,
                             torch.where(is_env, 1e8, dist))
    li_light = tr[:, None] * scene.lights_i[lidx] \
        / torch.clamp(dist * dist, min=1e-12)[:, None]
    li_env = tr[:, None] * scene.env_color * FOUR_PI
    return torch.where(is_env[:, None], li_env, li_light), \
        float(num_lights + 1)


def _xla_bounce(scene: Scene, cfg: RenderConfig, o, d, xi, xi_solve):
    """One bounce of rays [B,3] with their draws xi [B, 5] (free flight,
    NEE choice, light and direction) and xi_solve [B] (the uniform
    solver's) in plain PyTorch, as the JAX package's XLA branch
    (``gvr_tpu/integrators/multiscatter.py:567-586``): the ray-Gaussian
    coefficients (the candidate_k nearest-entering ones where 0 <
    candidate_k < N), the free flight by ``cfg.solver``, the albedo at
    the scatter point and NEE.  Returns (t_sc, scattered, albedo, li,
    w_ne)."""
    gmm = scene.medium
    rg = tau_coeffs(gmm, o, d)
    alb = gmm.albedo
    if 0 < cfg.candidate_k < gmm.n:
        rg, alb, _ = compact_candidates(rg, alb, cfg.candidate_k)
    target = -torch.log(torch.clamp(1.0 - xi[:, 0], min=1e-12))
    t_sc, scattered = sample_free_flight(
        rg, target, cfg.solver, cfg.solver_iters,
        xi_solve if cfg.solver == Solver.UNIFORM else None,
        finisher=cfg.solver_finisher)
    albedo = albedo_at_from_rg(rg, alb, t_sc)
    li, w_ne = _nee(scene, gmm, o + t_sc[:, None] * d, xi[:, 1], xi[:, 2],
                    xi[:, 3:5])
    return t_sc, scattered, albedo, li, w_ne


def multiscatter_radiance(scene: Scene, origin, direction, rng_ids,
                          cfg: RenderConfig, sample=0) -> torch.Tensor:
    """Radiance [B,3] of rays origin/direction [B,3] traced to completion
    one bounce at a time (``gvr_tpu/integrators/multiscatter.py:80-152``),
    each bounce's nine draws keyed by (rng_ids [B], sample, bounce)."""
    b = origin.shape[0]
    o, d = origin, direction
    thr = torch.ones((b, 3), dtype=torch.float32, device=origin.device)
    rad = torch.zeros_like(thr)
    alive = torch.ones(b, dtype=torch.bool, device=origin.device)
    for bounce in range(cfg.max_bounces):
        if not bool(alive.any()):
            break
        xi = uniform_planes(rng_ids, sample, bounce, BOUNCE_DRAWS, cfg.seed)
        t_sc, scattered, albedo, li, w_ne = _xla_bounce(scene, cfg, o, d,
                                                        xi[:5].T, xi[8])
        rad = rad + torch.where((alive & ~scattered)[:, None],
                                thr * scene.env_color, 0.0)
        alive_n = alive & scattered
        pos = o + t_sc[:, None] * d
        rad = rad + torch.where(
            alive_n[:, None], thr * (albedo * INV_4PI * w_ne)[:, None] * li,
            0.0)
        thr_n, killed = roulette(cfg, thr, albedo, bounce, xi[5])
        alive = alive_n & ~killed
        o = torch.where(alive[:, None], pos, o)
        d = torch.where(alive[:, None], dir_from_xi(xi[6:8].T), d)
        thr = torch.where(alive[:, None], thr_n, thr)
    return rad


def diff_uniforms(rng_ids: torch.Tensor, sample: int, n_bounces: int,
                  seed: int = 0) -> torch.Tensor:
    """The draws of ``multiscatter_radiance_diff``, [9, n_bounces, B]
    float32: those of bounce j keyed by (rng_ids, sample, j), in one K3
    launch (``uniform_planes``) for all the bounces."""
    bounces = torch.arange(n_bounces, dtype=torch.int32,
                           device=rng_ids.device)[:, None]
    pid = torch.broadcast_to(rng_ids.to(torch.int32),
                             (n_bounces, rng_ids.shape[0]))
    return uniform_planes(pid, sample, bounces, BOUNCE_DRAWS, seed)


def multiscatter_radiance_diff(scene: Scene, origin, direction, rng_ids,
                               cfg=None, n_bounces: int = 4, sample: int = 0,
                               seed: int = 0, candidate_k: int = 0,
                               rr_after: int = 0, rr_cap: float = 0.9,
                               return_overflow: bool = False, xi=None):
    """Radiance [B,3] of rays origin/direction [B,3], differentiable in
    the scene's medium (``gvr_tpu/integrators/multiscatter.py:155-256``;
    ``cfg`` is unused, as there).  Against the forward estimator:

    * a fixed trip of ``n_bounces`` bounces over every lane, dead lanes
      masked, no compaction and no in-place writes;
    * analytic escape: every bounce adds thr * exp(-tau_total) * env and
      conditions the free flight on scattering, target =
      -log1p(-u p_scat 0.999999), p_scat = 1 - exp(-tau_total), which
      keeps the image smooth in the parameters;
    * the scatter distance by ``solve_conditional_free_flight``,
      differentiable by the implicit function theorem, and 0 on dead
      lanes before it makes a position;
    * ``candidate_k > 0``: the solve and albedo over each ray's
      candidate_k nearest-entering Gaussians (``compact_candidates``);
    * ``rr_after > 0``: Russian roulette from that bounce on, its survival
      probability min(max(thr), rr_cap) detached, so the reweighting
      stays unbiased.

    ``xi``, the draws [9, n_bounces, B], is ``diff_uniforms(rng_ids,
    sample, n_bounces, seed)`` unless given (``inverse/fit`` draws them
    outside a checkpointed region, so its recompute draws nothing).
    ``return_overflow`` also returns (live lanes whose hits exceeded
    candidate_k, live lanes), summed over the bounces, as int32
    tensors."""
    gmm = scene.medium
    b = origin.shape[0]
    dev = origin.device
    use_compact = 0 < candidate_k < gmm.n
    if xi is None:
        xi = diff_uniforms(rng_ids, sample, n_bounces, seed)
    o, d = origin, direction
    thr = torch.ones((b, 3), dtype=torch.float32, device=dev)
    rad = torch.zeros((b, 3), dtype=torch.float32, device=dev)
    alive = torch.ones(b, dtype=torch.bool, device=dev)
    n_over = torch.zeros((), dtype=torch.int32, device=dev)
    n_live = torch.zeros((), dtype=torch.int32, device=dev)
    for bounce in range(n_bounces):
        x = xi[:, bounce]
        rg = tau_coeffs(gmm, o, d)
        if use_compact:
            rg, alb_k, overflow = compact_candidates(rg, gmm.albedo,
                                                     candidate_k)
            n_over = n_over + (overflow & alive).sum(dtype=torch.int32)
            n_live = n_live + alive.sum(dtype=torch.int32)
        t_esc = torch.exp(-tau_total(rg))
        rad = rad + torch.where(alive[:, None],
                                thr * t_esc[:, None] * scene.env_color, 0.0)
        p_scat = 1.0 - t_esc
        alive_n = alive & (p_scat.detach() > 1e-6)
        thr = thr * p_scat[:, None]
        target = -torch.log1p(-x[0] * p_scat * 0.999999)
        t_sc = torch.where(alive_n, solve_conditional_free_flight(rg, target),
                           0.0)
        pos = o + t_sc[:, None] * d
        if use_compact:
            albedo = albedo_at_from_rg(rg, alb_k, t_sc)
        else:
            tsg = t_sc.detach()[:, None]
            albedo = gmm.albedo_at(pos, rg.hit & (rg.t0 <= tsg)
                                   & (tsg <= rg.t1))
        li, w_ne = _nee(scene, gmm, pos, x[1], x[2], x[3:5].T)
        rad = rad + torch.where(
            alive_n[:, None], thr * (albedo * INV_4PI * w_ne)[:, None] * li,
            0.0)
        thr = thr * albedo[:, None]
        if 0 < rr_after <= bounce:
            surv = torch.clamp(thr.detach().amax(dim=-1), max=rr_cap)
            killed = x[5] > surv
            thr = torch.where((~killed)[:, None],
                              thr / torch.clamp(surv, min=1e-12)[:, None],
                              thr)
            alive_n = alive_n & ~killed
        o = torch.where(alive_n[:, None], pos, o)
        d = torch.where(alive_n[:, None], dir_from_xi(x[6:8].T), d)
        alive = alive_n
    if return_overflow:
        return rad, (n_over, n_live)
    return rad


def mc_camera_rays(scene: Scene, camera, cfg: RenderConfig, ids, sample_idx):
    """(o, d, ids): stratified primary rays of pixel ids [B] at sample
    ``sample_idx`` (integrator.h:557-570), jittered by the draws keyed
    (pixel, sample, JITTER_TAG)."""
    x, y = ids_to_pixels(ids, cfg.width)
    s = torch.full_like(ids, sample_idx, dtype=torch.int32)
    jit = uniform_planes(ids, s, JITTER_TAG, 2, cfg.seed)
    u, v = strat_uv(x, y, s, strat_n(cfg.spp), cfg.width, cfg.height,
                    jit[0], jit[1])
    o, d = camera.sample_ray(torch.stack([u, v], dim=-1))
    return o, d, ids


def _wavefront(scene: Scene, camera, cfg: RenderConfig, ids: torch.Tensor,
               bounce_fn, stats: dict | None) -> torch.Tensor:
    """Mean radiance [B,3] over the spp samples of each pixel id [B]
    (int32) by the dense wavefront of the step and XLA engines
    (``gvr_tpu/integrators/multiscatter.py:528-611``; the big-N engine's
    is ``_big_wavefront``, which keeps the live lanes on the device): one
    lane per pixel;
    a lane whose path ended starts its pixel's next sample, until every
    lane has traced spp samples or the loop has run spp * max_bounces +
    max_bounces iterations.  Each iteration is three steps over the live
    lanes: ``kernels/wavefront.wave_pre`` (regeneration, the jitter pair
    and the 9 bounce uniforms at (pixel, sample, bounce), the new samples'
    camera rays), ``bounce_fn(o, d, xi [live, 5], xi_solve [live])`` ->
    (t_sc, scattered, albedo, li, w_ne) of those lanes, and
    ``wave_post`` (escape adds throughput x env, a scatter adds the NEE
    term, Russian roulette and max_bounces end a path); on the card K8
    does each glue step in one launch.  One host read an iteration, the
    live lanes, which is also the loop condition.  JAX traces every lane
    and masks the finished ones; tracing only the live lanes gives the
    same results, as a lane's bounce does not depend on the others, and
    took less time on the card in the big-N engine (PERF.md, the A/B of
    compacted and every lane).  The XLA bounce's eager ops take their
    shapes from the host's count.  ``stats``, if given, receives
    'iterations' and 'bounce_evals' (live lanes traced).  Under
    ``utils.profiling``'s recorder each iteration is a
    ``wavefront.iteration`` span, its closing read a
    ``wavefront.live_read``, and the chunk counts ``lanes_traced`` (the
    live lanes traced) and ``lane_slots`` (lanes x iterations)."""
    b = ids.shape[0]
    env = scene.env_color
    lane = lanes(ids, camera)
    evals = 0
    it, cap = 0, cfg.spp * cfg.max_bounces + cfg.max_bounces
    # the one host read an iteration, at its end (the first before the
    # loop): the lanes with a path to trace, which are the next
    # iteration's live lanes after regeneration
    with profiling.span("wavefront.live_read"):
        live = torch.nonzero(lane.alive | (lane.sample < cfg.spp)).squeeze(1)
    while live.numel():
        with profiling.span("wavefront.iteration"):
            o, d, xi, xr = wave_pre(lane, live, cfg)
            evals += live.numel()
            # the live lanes only, in lane order; the others' results are
            # masked, as in JAX, where every lane is traced
            res = bounce_fn(o, d, xi, xr[-1])
            want = wave_post(lane, live, xr, res[:4], res[4], env, cfg)
            it += 1
            if it == cap:
                break
            with profiling.span("wavefront.live_read"):
                live = torch.nonzero(want).squeeze(1)
    profiling.count("lanes_traced", evals)
    profiling.count("lane_slots", b * it)
    if stats is not None:
        stats.update(iterations=it, bounce_evals=evals)
    return lane.acc / cfg.spp


def _table_wavefront(scene: Scene, camera, cfg: RenderConfig,
                     ids: torch.Tensor, stats: dict | None,
                     bounce) -> torch.Tensor:
    """``_wavefront`` with each bounce of the live lanes through one call
    ``bounce(o, d, xi [B,5], lights, env)`` of a bounce kernel's launcher
    (K2 on the step path; K4 and K5 where the tests hold the big-N loop
    to it), NEE weighted by L + 1 (1 with no lights)."""
    lights, env = scene.lights(), scene.env_color
    w_ne = float(lights.shape[0] + 1) if lights.shape[0] else 1.0

    def bounce_fn(o, d, xi, xi_solve):
        return bounce(o, d, xi, lights, env)[:4] + (w_ne,)

    return _wavefront(scene, camera, cfg, ids, bounce_fn, stats)


def wavefront_pixels_big(scene: Scene, camera, cfg: RenderConfig,
                         ids: torch.Tensor, stats: dict | None = None,
                         inputs: tuple | None = None) -> torch.Tensor:
    """Mean radiance [B,3] over the spp samples of each pixel id [B]
    (int32) by the big-N dense wavefront (``_big_wavefront``), each bounce
    of the live lanes through K4 and K5.  ``inputs`` is the path's
    (``pack_rows``, ``chunk_boxes``) of the scene, which the render's
    'big' entry builds once and passes to each chunk's call of this
    function (the per-chunk entry that ``benchmark_torch``'s big-N cell
    names); built here if not given."""
    table, boxes = inputs if inputs is not None else (
        pack_rows(scene.medium), chunk_boxes(scene.medium))
    return _big_wavefront(scene, camera, cfg, ids, stats, table, boxes)


# Iterations the big-N loop enqueues past the newest live count it has
# read before it waits for one (PERF.md: chosen on the card).
LIVE_READ_LEAD = 8


class _LiveCounts:
    """The live counts of a chunk's iterations on their way to the host.
    After iteration t the card copies counts[t + 1] (the lanes left for
    iteration t + 1) into a pinned slot and records an event; the host
    reads the slots in order, each once its event has completed, and
    waits for one only when asked (``wait``).  ``bound`` is the newest
    count read (an upper bound on every later one, as the live set only
    shrinks), ``live`` the iterations with live lanes once a count of 0
    has been read (None before), ``waits`` the waits.  On the CPU nothing
    runs behind the host: a count is read only when waited for, the
    card's worst case, so the CPU loop runs ``lead`` iterations ahead and
    ends with spare ones as the card's may."""

    def __init__(self, counts: torch.Tensor, bound: int, lead: int):
        self.counts, self.bound = counts, bound
        self.card = counts.device.type == "cuda"
        self.ring = lead + 1          # slots: one more than the unread
        if self.card:
            ring = torch.empty(self.ring, dtype=torch.int32,
                               pin_memory=True)
            self.host = ring.numpy()
            self.slots = list(ring)
            self.events = [torch.cuda.Event() for _ in range(self.ring)]
            self.stream = torch.cuda.current_stream(counts.device)
        self.pending = collections.deque()   # iterations sent, not read
        self.live, self.waits = None, 0

    def sent(self, t: int) -> None:
        """Iteration t has been enqueued."""
        if self.card:
            k = t % self.ring
            self.slots[k].copy_(self.counts[t + 1], non_blocking=True)
            self.events[k].record(self.stream)
        self.pending.append(t)

    def _read(self) -> None:
        t = self.pending.popleft()
        n = int(self.host[t % self.ring] if self.card
                else self.counts[t + 1])
        if n == 0:
            self.live = t + 1
        else:
            self.bound = n

    def poll(self) -> None:
        """Read every count whose copy has landed, without waiting."""
        while (self.card and self.live is None and self.pending
               and self.events[self.pending[0] % self.ring].query()):
            self._read()

    def wait(self) -> None:
        """Wait for the oldest count sent and read it."""
        with profiling.span("wavefront.live_read"):
            if self.card:
                self.events[self.pending[0] % self.ring].synchronize()
            self._read()
        self.waits += 1


def _big_kernel_step(lane, lists, counts, table, boxes, lights, env, w_ne,
                     cfg, overflow):
    """step(t, n): enqueue iteration t of the big-N loop on the card: K8
    pre, K4, K5 and K8 post over lists[t % 2]'s first counts[t] lanes,
    appending the lanes left to lists[1 - t % 2] and counts[t + 1]; n >=
    counts[t] sizes the grids.  The four launches are bound once, to
    buffers of the chunk's B lanes, which they keep."""
    pre, (o, d, xi, xr) = bind_wave_pre(lane, cfg)
    k4, s1 = bind_big_stage1(table, o, d, xi, lights, cfg.solver_iters,
                             boxes, overflow)
    k5, li = bind_big_nee(table, s1, env, boxes)
    post = bind_wave_post(lane, xr, (s1[0], s1[1], s1[2], li.T), w_ne, env,
                          cfg)
    ptrs = [x.data_ptr() for x in lists]
    c0 = counts.data_ptr()

    def step(t: int, n: int) -> None:
        live, nxt = ptrs[t % 2], ptrs[1 - t % 2]
        count = c0 + 4 * t
        pre(live, n, count)
        k4(n, count)
        k5(n, count)
        post(live, n, count, nxt, count + 4)

    return step


def _big_plain_step(lane, lists, counts, table, boxes, lights, env, w_ne,
                    cfg, overflow):
    """``_big_kernel_step``'s contract over the plain glue
    (``wave_pre_reference``, ``wave_post_reference``) and
    ``bounce_step_big`` (K4 and K5's plain versions on a CPU tensor):
    the CPU's step, and the card's reference.  It reads counts[t] and
    writes the next list in lane order; an iteration of no lanes does
    nothing."""

    def step(t: int, n: int) -> None:
        m = int(counts[t])
        if m == 0:
            return
        live = lists[t % 2][:m]
        o, d, xi, xr = wave_pre_reference(lane, live, cfg)
        res = bounce_step_big(table, o, d, xi, lights, env,
                              cfg.solver_iters, boxes, overflow)
        want = wave_post_reference(lane, live, xr, res[:4], w_ne, env, cfg)
        nxt = torch.nonzero(want).squeeze(1)
        lists[1 - t % 2][:nxt.numel()] = nxt
        counts[t + 1] = nxt.numel()

    return step


def _big_wavefront(scene: Scene, camera, cfg: RenderConfig,
                   ids: torch.Tensor, stats: dict | None, table,
                   boxes) -> torch.Tensor:
    """``_wavefront`` for the big-N engine with its live lanes kept on
    the device: the same lanes, iterations and image, bit for bit, with
    no host read an iteration.  Each iteration t runs the lanes of a live
    list lists[t % 2] [B] (int64), of which the first counts[t] are live
    (int32 [cap + 1] on the device), and K8's post appends the lanes left
    to the other list and counts[t + 1] (``_big_kernel_step``; on a CPU
    tensor ``_big_plain_step``).  The host sizes each launch by the newest
    count it has read (``_LiveCounts``), enqueues up to LIVE_READ_LEAD
    iterations past it, and stops once it reads a count of 0 or at cap =
    spp * max_bounces + max_bounces iterations; those it enqueued past
    the end ("spare") find a count of 0 and change nothing.  The list's
    order is K8's, not the lanes', which changes no lane's result.

    ``stats``, if given, receives 'iterations' (with live lanes),
    'spare_iterations' and 'bounce_evals' (live lanes traced, a device
    tensor).  Under ``utils.profiling``'s recorder each iteration is a
    ``wavefront.iteration`` span, with a ``wavefront.live_read`` child
    where the host waited for a count, and the chunk counts
    ``lanes_traced``, ``lane_slots`` (lanes x iterations),
    ``wavefront_spare_iterations``, ``wavefront_host_waits`` and
    ``big_list_overflow`` (the lanes traced whose crossed pairs overflowed
    K4's list), read from the device once, after the loop."""
    b, dev = ids.shape[0], ids.device
    lights, env = scene.lights(), scene.env_color
    w_ne = float(lights.shape[0] + 1) if lights.shape[0] else 1.0
    lane = lanes(ids, camera)
    cap = cfg.spp * cfg.max_bounces + cfg.max_bounces
    counts = torch.zeros(cap + 1, dtype=torch.int32, device=dev)
    counts[0] = b
    lists = (torch.arange(b, dtype=torch.int64, device=dev),
             torch.empty(b, dtype=torch.int64, device=dev))
    recording = profiling.recording()
    overflow = (torch.zeros(1, dtype=torch.int32, device=dev)
                if recording else None)
    make = _big_kernel_step if dev.type == "cuda" else _big_plain_step
    step = make(lane, lists, counts, table, boxes, lights, env, w_ne, cfg,
                overflow)
    reader = _LiveCounts(counts, b, LIVE_READ_LEAD)
    it = 0
    while reader.live is None and it < cap:
        with profiling.span("wavefront.iteration"):
            step(it, reader.bound)
            reader.sent(it)
            it += 1
            reader.poll()
            if (reader.live is None and it < cap
                    and len(reader.pending) >= LIVE_READ_LEAD):
                reader.wait()
    if stats is None and not recording:
        return lane.acc / cfg.spp
    live = reader.live
    if live is None:
        # at cap without a count of 0 read: the iterations with lanes
        live = int((counts[:it] > 0).sum())
    evals = counts[:it].sum(dtype=torch.int64)
    if recording:
        traced, over = torch.stack([evals, overflow[0].long()]).tolist()
        profiling.count("lanes_traced", traced)
        profiling.count("lane_slots", b * live)
        profiling.count("wavefront_spare_iterations", it - live)
        profiling.count("wavefront_host_waits", reader.waits)
        profiling.count("big_list_overflow", over)
    if stats is not None:
        stats.update(iterations=live, spare_iterations=it - live,
                     bounce_evals=evals)
    return lane.acc / cfg.spp


def wavefront_pixels_step(scene: Scene, camera, cfg: RenderConfig,
                          ids: torch.Tensor,
                          stats: dict | None = None) -> torch.Tensor:
    """Mean radiance [B,3] over the spp samples of each pixel id [B]
    (int32) by the step wavefront (``_wavefront``), each bounce of the
    live lanes through one launch of the fused bounce kernel K2
    (``bounce_step``; its plain version on a CPU tensor): the JAX
    package's ``_wavefront_planes_step``
    (``gvr_tpu/integrators/multiscatter.py:338-449``), which traces every
    lane in [R, 128] planes where this traces the live ones."""
    return _pixels("step", scene, camera, cfg, ids, stats)


def wavefront_pixels_xla(scene: Scene, camera, cfg: RenderConfig,
                         ids: torch.Tensor,
                         stats: dict | None = None) -> torch.Tensor:
    """Mean radiance [B,3] over the spp samples of each pixel id [B]
    (int32) by the dense XLA engine: the wavefront (``_wavefront``) with
    each bounce of the live lanes in plain PyTorch (``_xla_bounce``), the
    JAX package's XLA branch.  Any solver; ``candidate_k`` applies."""
    return _pixels("xla", scene, camera, cfg, ids, stats)


# ---- the paths: one entry each ---------------------------------------------
#
# An entry takes (scene, camera, cfg, device, found), moves what its path
# needs to the device, builds the path's inputs there once, and returns
# run(ids, stats) -> the mean radiance [B,3] of the pixel ids [B] (int32,
# on the device).  ``found`` is what the path's ``find`` took from the
# mixture before the render's clock started (the grid's).  ``stats``, if
# given, receives 'bounce_evals' (K1's evaluations, a device tensor; the
# live lanes or extension rays traced) and, on the wavefronts,
# 'iterations'.

def _mega(scene: Scene, camera, cfg: RenderConfig, device, found):
    """K1 once a chunk (``mega_call``); its counts are summed only where
    ``stats`` is asked for."""
    scene, camera = scene.to(device), camera.to(device)
    cam, table = camera_vector(camera), pack_table(scene.medium)
    lights, env = scene.lights(), scene.env_color
    pinhole = isinstance(camera, PinholeCamera)

    def run(ids, stats):
        sums, counts = mega_call(cam, table, ids, cfg, lights, env, pinhole)
        if stats is not None:
            stats["bounce_evals"] = counts.sum()
        return sums / cfg.spp

    return run


def _step(scene: Scene, camera, cfg: RenderConfig, device, found):
    """The step wavefront: K2 (``bounce_step``) on ``pack_table``'s rows."""
    scene, camera = scene.to(device), camera.to(device)
    table = pack_table(scene.medium)
    bounce = lambda o, d, xi, lights, env: bounce_step(
        table, o, d, xi, lights, env, cfg.solver_iters, cfg.solver_finisher)
    return lambda ids, stats: _table_wavefront(scene, camera, cfg, ids,
                                               stats, bounce)


def _big(scene: Scene, camera, cfg: RenderConfig, device, found):
    """The big-N wavefront on ``pack_rows``' rows and ``chunk_boxes``'
    boxes, through ``wavefront_pixels_big(inputs=)`` once a chunk: the
    benchmark's big-N cell names that function as the render's per-chunk
    entry, so ``inputs=`` can go when the benchmark no longer does."""
    scene, camera = scene.to(device), camera.to(device)
    inputs = pack_rows(scene.medium), chunk_boxes(scene.medium)
    return lambda ids, stats: wavefront_pixels_big(scene, camera, cfg, ids,
                                                   stats, inputs)


def _xla(scene: Scene, camera, cfg: RenderConfig, device, found):
    """The dense XLA engine: plain PyTorch over [rays, N] arrays."""
    scene, camera = scene.to(device), camera.to(device)
    bounce = lambda o, d, xi, xi_solve: _xla_bounce(scene, cfg, o, d, xi,
                                                    xi_solve)
    return lambda ids, stats: _wavefront(scene, camera, cfg, ids, bounce,
                                         stats)


def _grid(scene: Scene, camera, cfg: RenderConfig, device, found):
    """The pooled grid wavefront on the scene's grid ``found`` (by
    ``grid_for``, which ``engine_for`` built)."""
    grid = found.to(device)
    scene, camera = scene.to(device), camera.to(device)
    return lambda ids, stats: wavefront_pixels_grid_pooled(
        scene, grid, camera, cfg, ids, stats)


# path: (stats['engine'], the chunk rule (cfg, n, device) -> the pixels a
# chunk takes at most, the entry, and ``find`` (mixture) -> the entry's
# ``found``).  The XLA engine's [chunk, N] arrays keep its chunk within
# pick_chunk's element budget on any device.
_FIND_NOTHING = lambda gmm: None
_PATHS = {
    "mega": ("dense", pick_chunk, _mega, _FIND_NOTHING),
    "step": ("dense", pick_chunk, _step, _FIND_NOTHING),
    "big": ("dense", pick_chunk, _big, _FIND_NOTHING),
    "xla": ("dense", functools.partial(pick_chunk, dense=True), _xla,
            _FIND_NOTHING),
    "grid": ("grid", lambda cfg, n, device: min(cfg.ray_chunk, GRID_CHUNK),
             _grid, grid_for)}


def _pixels(path: str, scene: Scene, camera, cfg: RenderConfig,
            ids: torch.Tensor, stats: dict | None = None) -> torch.Tensor:
    """The mean radiance [B,3] of pixel ids [B] through ``path``'s entry,
    its inputs built for this call alone."""
    _, _, entry, find = _PATHS[path]
    return entry(scene, camera, cfg, ids.device, find(scene.medium))(ids,
                                                                     stats)


def render_multiscatter(scene: Scene, camera, cfg: RenderConfig,
                        device="cuda", progress: bool = False,
                        stats: dict | None = None,
                        mesh: Mesh | None = None) -> np.ndarray:
    """Full MC render on ``device``: [H, W, 3] float32 on the host.

    Results are scattered into a device image that is copied to the host
    once (the megakernel's launches are asynchronous; the step, XLA and
    grid wavefronts read one value per iteration, the big-N one a live
    count now and then, late).  ``progress`` prints the pixels done after
    each chunk.

    In a distributed job each pixel chunk is sharded over the ranks of
    ``mesh`` (``parallel.sharding.make_mesh()``, all ranks, by default),
    as the JAX package shards it over all devices
    (``gvr_tpu/integrators/multiscatter.py:614-626, 738-742``): the chunk
    is padded to a multiple of the shard count, preferring whole 256-ray
    blocks per shard; each rank renders its contiguous slice of every
    chunk through the engine it would pick alone; one all-reduce of the
    image, zero outside each rank's pixels, assembles it, and every rank
    returns the whole image.  Radiance is keyed by pixel id, so it is the
    one-process image.

    ``stats``, if given, receives the engine ('grid' on the grid, else
    'dense'), the kernel (the path by ``render_path``: 'mega', 'step',
    'big', 'grid' or 'xla'), the render's seconds (host clock, after the
    path's choice, ending with the copy to the host), the seconds of the
    path's choice with the grid build (``grid_seconds``; a cached grid
    costs only its content hash), paths, bounce evaluations (the
    megakernel's count; on the wavefronts the live lanes or extension rays
    traced; summed over the ranks), the chunk and the chunks, wavefront
    iterations with live lanes (this rank's) and the big-N loop's spare
    ones (enqueued past a chunk's end, ``spare_iterations``), Gaussian
    count, the shard count and the assembly's seconds.

    The render is the root span ``render_multiscatter`` of
    ``utils.profiling``, which records while a torch.profiler runs or a
    ``RenderStats`` is given as ``stats``: inside it ``render.prepare``
    (from entry to the first chunk: the path's choice with ``grid_for``,
    the tile order, and the path's entry: the moves to the device, the
    chunk size and the tables), a ``chunk`` span a chunk (the host's
    enqueue: nothing waits for the device), the wavefronts'
    ``wavefront.iteration`` spans with their ``wavefront.live_read`` and
    counters (``_wavefront``, ``_big_wavefront``,
    ``gridscatter.wavefront_pixels_grid_pooled``), and
    ``render.readback`` (the all-reduce, the copy to the host)."""
    with profiling.render("render_multiscatter", stats) as root:
        return _render(scene, camera, cfg, device, progress, stats, mesh,
                       root)


def _render(scene: Scene, camera, cfg: RenderConfig, device, progress,
            stats, mesh, root) -> np.ndarray:
    """The body of ``render_multiscatter``; ``root`` is its span."""
    scene.require_gaussian("render_multiscatter")
    mesh = mesh if mesh is not None else make_mesh()
    n_shards = mesh.shape[RAY_AXIS]
    with profiling.span("render.prepare"):
        t_build = time.perf_counter()
        path = render_path(cfg, scene.medium)
        engine, chunk_for, entry, find = _PATHS[path]
        found = find(scene.medium)
        t0 = time.perf_counter()
        w, h = cfg.width, cfg.height
        order = tile_ids(w, h, device)
        img = torch.zeros((w * h, 3), dtype=torch.float32, device=device)
        evals = torch.zeros((), dtype=torch.int64, device=device)
        n_chunks = iterations = spare = 0
        run = entry(scene, camera, cfg, device, found)
        chunk = chunk_for(cfg, scene.medium.n, device)
        chunk = min(chunk, ((w * h + 255) // 256) * 256)
        q = 256 * n_shards if chunk >= 256 * n_shards else n_shards
        chunk = -(-chunk // q) * q
        lo, hi = shard_bounds(chunk, mesh)
    for start in range(0, w * h, chunk):
        # this rank's slice of the chunk; the last chunk's may be short
        # or empty
        ids = order[start + lo:min(start + hi, w * h)]
        st = {} if stats is not None else None
        with profiling.span("chunk", pixels=ids.numel(),
                            paths=ids.numel() * cfg.spp, engine=engine,
                            kernel=path, shards=n_shards):
            if ids.numel():
                img[ids] = run(ids, st)
                if st is not None:
                    evals += st["bounce_evals"]
                    iterations += st.get("iterations", 0)
                    spare += st.get("spare_iterations", 0)
        n_chunks += 1
        if progress:
            print(f"  pixels {min(start + chunk, w * h)}/{w * h}")
    with profiling.span("render.readback"):
        t_assemble = time.perf_counter()
        group = mesh.group(RAY_AXIS)
        if group is not None:
            _synchronize(device)
            t_assemble = time.perf_counter()
            dist.all_reduce(img, group=group)
            if stats is not None:
                dist.all_reduce(evals, group=group)
        out = img.cpu().numpy().reshape(h, w, 3)
    t_end = time.perf_counter()
    if stats is not None:
        stats.update(engine=engine, kernel=path, seconds=t_end - t0,
                     grid_seconds=t0 - t_build,
                     paths=w * h * cfg.spp, bounce_evals=int(evals),
                     chunk=chunk, chunks=n_chunks, iterations=iterations,
                     spare_iterations=spare,
                     n=scene.medium.n, device=str(device), shards=n_shards,
                     assemble_seconds=t_end - t_assemble)
    root.set(engine=engine, kernel=path, shards=n_shards,
             n=scene.medium.n, paths=w * h * cfg.spp,
             mpaths_per_s=round(profiling.mrays_per_sec(w * h * cfg.spp,
                                                        t_end - t0), 3))
    return out


def _synchronize(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
