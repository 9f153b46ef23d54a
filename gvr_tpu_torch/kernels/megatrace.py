"""The whole sample/bounce loop of a pixel chunk: the plain version and the
pooled CUDA megakernel (K1).

Replaces ``gvr_tpu/kernels/megatrace.py:501 mega_call`` (body
``_make_mega_kernel_pooled`` :273).  Per (pixel, sample) path: a stratified
camera ray with hash-RNG jitter, then bounces of ``pathtrace`` K2's math
until the path escapes, is killed by Russian roulette (from ``min_scatter``,
cap ``rr_cap``, ``rr_cap_tail`` from bounce ``rr_tail_after``) or reaches
``max_bounces``; escape adds throughput x env, each scatter adds the NEE
term, and the direction is resampled isotropically.  RNG streams are keyed
by (pixel, sample, bounce), so which thread or lane traces a sample never
changes its radiance.

Plain version (``mega_reference``): the per-lane wavefront of
``gvr_tpu/integrators/multiscatter.py:wavefront_pixels`` (one lane per
pixel; a lane whose path ended starts the pixel's next sample) around
``bounce_core_reference``.

Kernel (``csrc/kernels.cu:mega_kernel``): one block owns 128 consecutive
ids of the chunk, and their 128 x spp (pixel, sample) slots form a pool.  A
thread without a live path claims the next slot with a shared-memory
atomic, traces that path bounce by bounce, adds its radiance into the
pixel's shared accumulator when it ends, and claims again; the block writes
its pixel sums when the pool is empty.  It is bound by the bounce math
(K2's device function, arithmetic and special functions); path-length
variance within a block is absorbed by the pool, and the state of a path
never leaves registers.  Sums arrive in a run-dependent order, so images
match the plain version to float tolerance, not bit for bit.
"""

from __future__ import annotations

import ctypes
import math

import numpy as np
import torch

from gvr_tpu_torch.cameras import PinholeCamera, camera_rays
from gvr_tpu_torch.integrators.common import ids_to_pixels
from gvr_tpu_torch.kernels import _build
from gvr_tpu_torch.kernels.pathtrace import (bounce_core_reference,
                                             check_lights, check_table)
from gvr_tpu_torch.kernels.rng import JITTER_TAG, seed_words
from gvr_tpu_torch.ops.sampling import dir_from_xi, path_uniforms

INV_4PI = 1.0 / (4.0 * math.pi)


def camera_vector(camera) -> torch.Tensor:
    """[16] float32 on the camera's device: position, right, up,
    view_dir, focal (0 for orthographic), 3 zeros."""
    dev = camera.position.device
    if isinstance(camera, PinholeCamera):
        focal = camera.focal().reshape(1)
    else:
        focal = torch.zeros(1, dtype=torch.float32, device=dev)
    return torch.cat([camera.position, camera.right, camera.up,
                      camera.view_dir, focal,
                      torch.zeros(3, dtype=torch.float32, device=dev)])


def strat_n(spp: int) -> int:
    """Stratification side: sqrt(spp) for a perfect square, else 1."""
    n = max(int(spp ** 0.5), 1)
    return n if n * n == spp else 1


def strat_uv(x, y, sample_idx, n_strat: int, w: int, h: int, xi0, xi1):
    """Stratified sub-pixel position (integrator.h:562-566): cell
    (s % n, (s // n) % n) plus jitter, normalized to [0,1); true division,
    as the megakernel does it."""
    sx = (sample_idx % n_strat).to(torch.float32)
    sy = ((sample_idx // n_strat) % n_strat).to(torch.float32)
    u = (x.to(torch.float32) + (sx + xi0) / n_strat) / w
    v = (y.to(torch.float32) + (sy + xi1) / n_strat) / h
    return u, v


def mega_reference(cam_vec, table, ids, cfg, lights, env, pinhole: bool):
    """Plain version of K1.  ids [B] int32 pixel ids; cfg a RenderConfig.
    Returns (radiance sums over the spp samples [B,3], bounce evaluations
    per pixel [B] int32)."""
    mega_reference.launches += 1
    dev = ids.device
    b = ids.shape[0]
    w, h, spp = cfg.width, cfg.height, cfg.spp
    n_strat = strat_n(spp)
    ids64 = ids.to(torch.int64)
    x, y = ids_to_pixels(ids64, w)
    env3 = env[None, :]
    w_ne = float(lights.shape[0] + 1) if lights.shape[0] else 1.0

    o = torch.zeros((b, 3), device=dev)
    d = torch.zeros((b, 3), device=dev)
    thr = torch.ones((b, 3), device=dev)
    acc = torch.zeros((b, 3), device=dev)
    alive = torch.zeros(b, dtype=torch.bool, device=dev)
    sample = torch.zeros(b, dtype=torch.int64, device=dev)
    bounce = torch.zeros(b, dtype=torch.int64, device=dev)
    evals = torch.zeros(b, dtype=torch.int32, device=dev)
    while bool((alive | (sample < spp)).any()):
        regen = ~alive & (sample < spp)
        s_new = torch.where(regen, sample, 0)
        jit = path_uniforms(ids64, s_new, JITTER_TAG, 2, cfg.seed)
        u01, v01 = strat_uv(x, y, s_new, n_strat, w, h, jit[:, 0],
                            jit[:, 1])
        o_n, d_n = camera_rays(cam_vec[0:3], cam_vec[3:6], cam_vec[6:9],
                               cam_vec[9:12], cam_vec[12] if pinhole else None,
                               torch.stack([u01, v01], dim=-1))
        o = torch.where(regen[:, None], o_n, o)
        d = torch.where(regen[:, None], d_n, d)
        thr = torch.where(regen[:, None], 1.0, thr)
        bounce = torch.where(regen, 0, bounce)
        sample = torch.where(regen, sample + 1, sample)
        alive = alive | regen

        xi = path_uniforms(ids64, torch.clamp(sample, min=1) - 1, bounce, 9,
                           cfg.seed)
        t_sc, scattered, albedo, li, _, _ = bounce_core_reference(
            table, o, d, xi, lights, env, cfg.solver_iters,
            cfg.solver_finisher)
        evals += alive.to(torch.int32)

        acc = acc + torch.where((alive & ~scattered)[:, None], thr * env3,
                                0.0)
        alive_n = alive & scattered
        pos = o + t_sc[:, None] * d
        wgt = albedo * (INV_4PI * w_ne)
        acc = acc + torch.where(alive_n[:, None], thr * wgt[:, None] * li,
                                0.0)

        thr_n = thr * albedo[:, None]
        do_rr = bounce >= cfg.min_scatter
        cap = torch.where(bounce >= cfg.rr_tail_after, cfg.rr_cap_tail,
                          cfg.rr_cap).to(torch.float32)
        rr = torch.minimum(thr_n.amax(dim=-1), cap)
        killed = do_rr & (xi[:, 5] > rr)
        thr_n = torch.where((do_rr & ~killed)[:, None],
                            thr_n / torch.clamp(rr, min=1e-12)[:, None],
                            thr_n)
        alive_n = alive_n & ~killed & (bounce + 1 < cfg.max_bounces)

        new_d = dir_from_xi(xi[:, 6:8])
        o = torch.where(alive_n[:, None], pos, o)
        d = torch.where(alive_n[:, None], new_d, d)
        thr = torch.where(alive_n[:, None], thr_n, thr)
        alive = alive_n
        bounce = bounce + 1
    return acc, evals


mega_reference.launches = 0


def mega_call(cam_vec, table, ids, cfg, lights, env, pinhole: bool):
    """Radiance sums [B,3] and bounce evaluations [B] for the spp samples
    of each pixel id in ``ids``; the arguments of ``mega_reference``.  A CPU
    tensor takes the plain version; a CUDA tensor launches K1 or raises."""
    if ids.device.type == "cpu":
        return mega_reference(cam_vec, table, ids, cfg, lights, env, pinhole)
    dev = ids.device
    b = ids.shape[0]
    _build.check(cam_vec, "cam_vec", torch.float32, (16,), dev)
    _build.check(ids, "ids", torch.int32, (b,), dev)
    check_table(table, dev)
    check_lights(lights, env, dev)
    out_rad = torch.empty((b, 3), dtype=torch.float32, device=dev)
    out_count = torch.empty(b, dtype=torch.int32, device=dev)
    n_lights = lights.shape[0]
    nee_w = float(np.float32(INV_4PI * (n_lights + 1 if n_lights else 1)))
    seed_mix, seed_raw = seed_words(cfg.seed)
    _build.launch(
        "gvr_mega", _build.ptr(cam_vec), _build.ptr(table), table.shape[0],
        _build.ptr(ids), b, _build.ptr(lights), n_lights, _build.ptr(env),
        nee_w, cfg.width, cfg.height, cfg.spp, strat_n(cfg.spp),
        ctypes.c_uint32(seed_mix), ctypes.c_uint32(seed_raw),
        cfg.solver_iters, int(cfg.solver_finisher), cfg.min_scatter,
        cfg.rr_cap, cfg.rr_tail_after, cfg.rr_cap_tail, cfg.max_bounces,
        int(pinhole), _build.ptr(out_rad), _build.ptr(out_count),
        device=dev)
    mega_call.launches += 1
    return out_rad, out_count


mega_call.launches = 0
