"""Grid regular-tracking wavefront: the multiscatter engine for scenes above
GRID_MIN_N Gaussians.

Counterpart of ``gvr_tpu/integrators/gridscatter.py``: the estimator and
RNG streams of ``integrators/multiscatter`` (NEE each bounce, isotropic
phase, Russian roulette), with every transmittance and free-flight
evaluation taken over the uniform grid (``accel/grid``):

  per iteration
    1. DDA of [extension rays ; the previous bounce's NEE rays] into
       t-ordered cell crossings, and one K6 pass for every crossing's tau;
    2. the NEE rays' transmittance lands in their samples' slots;
    3. per extension ray, the running tau picks the critical crossing and
       K7 solves for the scatter point and albedo in that cell;
    4. escape, NEE set-up, throughput, Russian roulette, a new direction.

Only the pooled wavefront is ported (``pool_regen`` is the JAX package's
default): a lane whose path ended claims the chunk's next untraced
(pixel, sample).  Each iteration reads one small tensor back to the host
for the loop condition and the pool's claim counter.
"""

from __future__ import annotations

import hashlib

import numpy as np
import torch

from gvr_tpu_torch.accel.grid import GridIndex, build_grid, dda_crossings
from gvr_tpu_torch.config import RenderConfig
from gvr_tpu_torch.kernels.gridtrace import solve_pass, span_tau_pass
from gvr_tpu_torch.kernels.megatrace import INV_4PI, strat_n, strat_uv
from gvr_tpu_torch.kernels.pathtrace import FOUR_PI
from gvr_tpu_torch.kernels.rng import BOUNCE_DRAWS, wave_uniforms
from gvr_tpu_torch.kernels.wavefront import roulette
from gvr_tpu_torch.ops.sampling import dir_from_xi
from gvr_tpu_torch.scene.scene import Scene
from gvr_tpu_torch.utils.profiling import count, span

NO_SCATTER = -1.0        # t_sc of a ray that escapes (gvr_tpu ops/solvers)


def grid_tau_crossings(grid: GridIndex, o, d, tmax=None):
    """Per-crossing optical depth, t-ordered: (tau [B,C], cells [B,C],
    t_in [B,C], t_out [B,C]); unused and empty slots have tau 0."""
    cells, t_in, t_out = dda_crossings(grid, o, d, tmax)
    tm = torch.full((o.shape[0],), 1e8, dtype=torch.float32,
                    device=o.device) if tmax is None else tmax
    return span_tau_pass(grid, o, d, tm, cells), cells, t_in, t_out


def grid_transmittance(grid: GridIndex, o, d, tmax=None):
    """exp(-optical depth up to tmax): NEE shadow and env transmittance
    (reference ``gmm.h:517-578``)."""
    tau, *_ = grid_tau_crossings(grid, o, d, tmax)
    return torch.exp(-tau.sum(dim=-1))


def grid_free_flight(grid: GridIndex, o, d, u_tau, solver_iters: int = 6):
    """Free-flight sampling by grid regular tracking: (t_sc [B],
    scattered [B], albedo [B], tau_tot [B])."""
    tau, cells, t_in, t_out = grid_tau_crossings(grid, o, d)
    return grid_solve_from_crossings(grid, o, d, tau, cells, t_in, t_out,
                                     u_tau, solver_iters)


def critical_crossing(grid: GridIndex, tau, cells, t_in, t_out, u_tau):
    """Per ray, the crossing where the running tau passes the free-flight
    target -log(1 - u_tau): (scattered [B], tau_tot [B], cell [B] int32,
    -1 where the ray escapes, t_in [B], t_out [B], residual tau [B] still
    to go inside that cell)."""
    cum = torch.cumsum(tau.T, dim=0).T       # the outer-axis scan, see DDA
    tau_tot = cum[:, -1]
    target = -torch.log(torch.clamp(1.0 - u_tau, min=1e-12))
    scattered = tau_tot > target
    # u_tau == 0 gives target 0, whose critical slot could be an empty
    # cell; the tiny floor lands it on the first occupied crossing
    # (gvr_tpu/integrators/gridscatter.py:134-141)
    tgt = torch.clamp(torch.minimum(target, tau_tot * 0.999999), min=1e-12)
    crit = (cum < tgt[:, None]).sum(dim=-1, keepdim=True)
    crit = torch.clamp(crit, 0, grid.c_max - 1)
    pick = lambda x: x.gather(1, crit)[:, 0]
    residual = torch.clamp(tgt - (pick(cum) - pick(tau)), min=0.0)
    return (scattered, tau_tot, torch.where(scattered, pick(cells), -1),
            pick(t_in), pick(t_out), residual)


def grid_solve_from_crossings(grid: GridIndex, o, d, tau, cells, t_in,
                              t_out, u_tau, solver_iters: int = 6):
    """The critical crossing of each ray and K7 in its cell, given the
    per-crossing taus (apart from the tau pass so that the wavefront can
    trace extension and NEE rays in one K6 pass).  Returns (t_sc [B],
    scattered [B], albedo [B], tau_tot [B])."""
    scattered, tau_tot, cell_c, tin_c, tout_c, residual = \
        critical_crossing(grid, tau, cells, t_in, t_out, u_tau)
    # K7 takes the rays in lane order: sorting them by cell measured 0.22 ms
    # an iteration and saved K7 0.01-0.18 ms (NVIDIA H100 80GB HBM3,
    # 700.00 W; PERF.md)
    t_sc, albedo = solve_pass(grid, o, d, tin_c, tout_c, residual, cell_c,
                              solver_iters)
    return (torch.where(scattered, t_sc, NO_SCATTER), scattered,
            torch.where(scattered, albedo, 0.0), tau_tot)


def _nee_select(scene: Scene, pos, xi_choice, xi_light, xi_env2):
    """NEE light/env choice (integrator.h:657-683) without the
    transmittance: (wi [B,3], tmax [B], base [B,3], w_ne) such that
    Li = transmittance(pos, wi, tmax) * base."""
    b = pos.shape[0]
    n_l = scene.num_lights
    wi_env = dir_from_xi(xi_env2)
    env_base = (scene.env_color * FOUR_PI).expand(b, 3)
    if n_l == 0:
        return wi_env, torch.full((b,), 1e8, device=pos.device), \
            env_base, 1.0
    is_env = xi_choice < 1.0 / (n_l + 1)
    lidx = torch.clamp((xi_light * n_l).long(), 0, n_l - 1)
    to_l = scene.lights_p[lidx] - pos
    dist = torch.linalg.vector_norm(to_l, dim=-1)
    wi_l = to_l / torch.clamp(dist, min=1e-12)[:, None]
    base_l = scene.lights_i[lidx] / torch.clamp(dist * dist,
                                                min=1e-12)[:, None]
    return (torch.where(is_env[:, None], wi_env, wi_l),
            torch.where(is_env, 1e8, dist),
            torch.where(is_env[:, None], env_base, base_l), float(n_l + 1))


def wavefront_pixels_grid_pooled(scene: Scene, grid: GridIndex, camera,
                                 cfg: RenderConfig, ids: torch.Tensor,
                                 stats: dict | None = None):
    """Mean radiance [B,3] over the spp samples of each pixel id [B]
    (int32), by the pooled grid wavefront
    (``gvr_tpu/integrators/gridscatter.py:313``).

    Slot g of the pool is pixel ids[g // spp], sample g % spp; a lane
    whose path ended claims the next slot.  Each sample adds into its own
    slot, one add per slot per ``index_add_`` (dead lanes add into the
    dummy row pool_n), and a pixel sums its slots in sample order, so the
    result does not depend on the chunk.  ``stats``, if given, receives
    'iterations' and 'bounce_evals' (the extension rays traced).  Under
    ``utils.profiling``'s recorder each iteration is a
    ``wavefront.iteration`` span, its closing read a
    ``wavefront.live_read``, and the chunk counts ``lanes_traced`` (the
    extension rays) and ``lane_slots`` (lanes x iterations)."""
    dev = ids.device
    b = ids.shape[0]
    w, h, spp = cfg.width, cfg.height, cfg.spp
    pool_n = b * spp
    n_strat = strat_n(spp)
    cap = spp * cfg.max_bounces + cfg.max_bounces + 1
    f32 = dict(dtype=torch.float32, device=dev)

    o = torch.zeros((b, 3), **f32)
    d = torch.ones((b, 3), **f32)
    thr = torch.ones((b, 3), **f32)
    slots = torch.zeros((pool_n + 1, 3), **f32)
    alive = torch.zeros(b, dtype=torch.bool, device=dev)
    px = ids.clone()
    smp = torch.zeros(b, dtype=torch.int32, device=dev)
    g = torch.zeros(b, dtype=torch.int64, device=dev)
    bounce = torch.zeros(b, dtype=torch.int32, device=dev)
    p_pos = torch.zeros((b, 3), **f32)
    p_wi = torch.ones((b, 3), **f32)
    p_tmax = torch.zeros(b, **f32)
    p_val = torch.zeros((b, 3), **f32)
    p_g = torch.full((b,), pool_n, dtype=torch.int64, device=dev)
    ext_rays = torch.zeros((), dtype=torch.int64, device=dev)
    planes = torch.empty((2 + BOUNCE_DRAWS, b), **f32)   # K3's, reused
    next_g, it, lanes = 0, 0, 0
    # the one host read an iteration, at its end (the first before the
    # loop): live lanes, pending NEE
    with span("wavefront.live_read"):
        n_alive, pending = torch.stack(
            [alive.sum(), (p_val > 0.0).any().long()]).tolist()
    while n_alive or next_g < pool_n or pending:
        with span("wavefront.iteration"):
            # pooled regeneration: dead lanes claim consecutive slots
            dead = ~alive
            di = dead.long()
            g_new = next_g + torch.cumsum(di, 0) - di
            regen = dead & (g_new < pool_n)
            g = torch.where(regen, g_new, g)
            px = torch.where(regen, ids[torch.clamp(g_new // spp, 0, b - 1)],
                             px)
            smp = torch.where(regen, (g_new % spp).to(torch.int32), smp)
            claimed = min(next_g + b - n_alive, pool_n) - next_g
            next_g += claimed
            lanes += n_alive + claimed

            bounce = torch.where(regen, 0, bounce)
            # one K3 launch: the jitter pair (used where regen), then xi [9, B]
            jit, xi = wave_uniforms(px, smp, bounce, cfg.seed,
                                    out=planes).split([2, BOUNCE_DRAWS])
            u, v = strat_uv(px % w, px // w, smp, n_strat, w, h, jit[0],
                            jit[1])
            o_n, d_n = camera.sample_ray(torch.stack([u, v], dim=-1))
            o = torch.where(regen[:, None], o_n, o)
            d = torch.where(regen[:, None], d_n, d)
            thr = torch.where(regen[:, None], 1.0, thr)
            alive = alive | regen
            ext_rays += alive.sum()

            # one DDA and K6 pass over [extension rays ; pending NEE rays]
            tau2, cells2, tin2, tout2 = grid_tau_crossings(
                grid, torch.cat([o, p_pos]), torch.cat([d, p_wi]),
                torch.cat([torch.where(alive, 1e8, 0.0), p_tmax]))
            tr = torch.exp(-tau2[b:].sum(dim=-1))
            slots.index_add_(0, p_g, tr[:, None] * p_val)

            t_sc, scattered, albedo, _ = grid_solve_from_crossings(
                grid, o, d, tau2[:b], cells2[:b], tin2[:b], tout2[:b], xi[0],
                cfg.grid_solver_iters)
            escaped = alive & ~scattered
            slots.index_add_(0, torch.where(escaped, g, pool_n),
                             thr * scene.env_color)
            alive_n = alive & scattered

            pos = o + torch.clamp(t_sc, min=0.0)[:, None] * d
            wi, tmax_n, base, w_ne = _nee_select(scene, pos, xi[1], xi[2],
                                                 xi[3:5].T)
            weight = thr * (albedo * (INV_4PI * w_ne))[:, None] * base
            p_val = torch.where(alive_n[:, None], weight, 0.0)
            p_tmax = torch.where(alive_n, tmax_n, 0.0)
            p_g = torch.where(alive_n, g, pool_n)
            p_pos, p_wi = pos, wi

            thr_n, killed = roulette(cfg, thr, albedo, bounce, xi[5])
            alive = alive_n & ~killed & (bounce + 1 < cfg.max_bounces)
            o = torch.where(alive[:, None], pos, o)
            d = torch.where(alive[:, None], dir_from_xi(xi[6:8].T), d)
            thr = torch.where(alive[:, None], thr_n, thr)
            bounce = bounce + 1
            it += 1
            if it == cap:
                break
            with span("wavefront.live_read"):
                n_alive, pending = torch.stack(
                    [alive.sum(), (p_val > 0.0).any().long()]).tolist()
    count("lanes_traced", lanes)
    count("lane_slots", b * it)
    if stats is not None:
        stats.update(iterations=it, bounce_evals=int(ext_rays))
    return slots[:pool_n].reshape(b, spp, 3).sum(dim=1) / spp


_GRID_CACHE: dict = {}


def grid_for(gmm) -> GridIndex:
    """The scene's grid, built once per mixture content and kept for the
    next call (one entry: tables can be large).  The key is a digest of
    the arrays that determine the grid, so an edit that keeps their sums
    (swapping two coordinates) still rebuilds.  Its span ``grid_for``
    (``utils.profiling``) says whether it ``built``."""
    with span("grid_for") as sp:
        hsh = hashlib.blake2b(digest_size=16)
        for t in (gmm.mean, gmm.density, gmm.albedo, gmm.eigvals,
                  gmm.eigvecs):
            hsh.update(np.ascontiguousarray(t.detach().cpu().numpy())
                       .tobytes())
        key = (gmm.n, str(gmm.mean.device), hsh.hexdigest())
        grid = _GRID_CACHE.get(key)
        sp.set(built=grid is None)
        if grid is None:
            grid = build_grid(gmm)
            _GRID_CACHE.clear()
            _GRID_CACHE[key] = grid
        return grid
