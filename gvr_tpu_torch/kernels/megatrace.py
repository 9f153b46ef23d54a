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

Kernel (``csrc/kernels.cu:mega_kernel``): one block of 128 threads owns
``pool_pixels`` consecutive ids of the chunk (chosen from spp so that the
chunk makes several waves of blocks on the card), and their (pixel,
sample) slots form a pool, run in rounds of at most 512 slots
(``MEGA_ROUND``).  A warp's lanes without a live path claim the
round's next slots with one shared-memory atomic, trace their paths bounce
by bounce, and claim again.  A bounce sweeps all rows for the extension
ray behind a division-free pre-test, keeps the crossed pairs in shared
memory for the solve, and solves only where the ray scatters; its shadow
ray goes into a per-warp FIFO queue that the warp sweeps 32 entries at a
time with every lane active.  It is bound by the bounce math (K2's device
functions, arithmetic and special functions): on the headline's heaviest
chunk its warps spend ~57 % of their cycles in the extension sweeps and
~23 % in the shadow-ray sweeps, a pre-test of every row each (PERF.md),
and the state of a path never leaves registers.

Each path has one subtotal in shared memory; its terms reach it through
the queue in the order the path made them (its shadow rays in bounce
order, then its escape), and at a round's end the block adds each
pixel's subtotals in sample order.  So the image is the same bits from
run to run, whichever warp traced which path, and for any pool size,
chunk or card.  It matches the plain version (which adds each term into
the pixel's sum as it comes) to float tolerance, not bit for bit.
"""

from __future__ import annotations

import ctypes
import functools
import math

import numpy as np
import torch
import torch.nn.functional as F

from gvr_tpu_torch.cameras import PinholeCamera, camera_rays
from gvr_tpu_torch.integrators.common import ids_to_pixels
from gvr_tpu_torch.kernels import _build
from gvr_tpu_torch.kernels.pathtrace import (_coeffs, _interval, _nee_ray,
                                             bounce_core_reference,
                                             check_lights, check_table)
from gvr_tpu_torch.kernels.pathtrace_big import (GROUP, _union_boxes,
                                                 chunk_box_hits_reference)
from gvr_tpu_torch.kernels.rng import JITTER_TAG, seed_words
from gvr_tpu_torch.ops.sampling import dir_from_xi, path_uniforms
from gvr_tpu_torch.scene.gaussians import R_CUT, morton_order

INV_4PI = 1.0 / (4.0 * math.pi)
MEGA_BLOCK = 128            # threads of a K1 block (csrc/kernels.cu)
MEGA_MAX_PIX = 128          # most pixels one block's pool holds
POOL_PATHS = 4 * MEGA_BLOCK  # paths a block's pool aims at
FILL_WAVES = 4              # waves of resident blocks a chunk should make
# The phases of K1's optional counters (csrc/kernels.cu MegaPhase), each
# [cycles, warp-steps, active lanes summed over the steps].
MEGA_PHASES = ("sweep", "solve", "nee", "other")


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


def pool_pixels(spp: int, b: int, resident: int) -> int:
    """Pixels of one K1 block's pool for a chunk of ``b`` pixels at ``spp``
    on a card that holds ``resident`` blocks at once: about POOL_PATHS
    paths a block, fewer where the chunk would then make under FILL_WAVES
    waves of blocks, but never fewer paths than threads."""
    pix = min(max(1, POOL_PATHS // spp), max(1, b // (FILL_WAVES * resident)))
    return min(MEGA_MAX_PIX, max(pix, -(-MEGA_BLOCK // spp)))


@functools.lru_cache(maxsize=None)
def resident_blocks(device) -> tuple:
    """(K1 blocks one SM holds at once, SMs) on CUDA ``device``."""
    per_sm, sms = ctypes.c_int(0), ctypes.c_int(0)
    with torch.cuda.device(device):
        rc = _build.library().gvr_mega_resident(ctypes.byref(per_sm),
                                                ctypes.byref(sms))
    if rc != 0:
        raise RuntimeError(f"gvr_mega_resident: CUDA error {rc}")
    return per_sm.value, sms.value


def phase_split(phases: torch.Tensor) -> dict:
    """K1's phase counters [4, 3] as {phase: (share of the cycles, active
    lanes per warp-step)}."""
    ph = phases.double().cpu()
    total = float(ph[:, 0].sum()) or 1.0
    return {name: (float(ph[k, 0]) / total,
                   float(ph[k, 2]) / max(float(ph[k, 1]), 1.0))
            for k, name in enumerate(MEGA_PHASES)}


def group_boxes(table) -> tuple:
    """(boxes [K, 8], rows [K]) of a ``pack_table`` table's valid rows in
    the Morton order of their means, GROUP rows a group: each box the
    union of its rows' R_CUT ellipsoid boxes (half-extent R_CUT
    sqrt(inv(A)_ii)), widened as ``pathtrace_big.chunk_boxes`` widens its
    boxes.  K1 does not cull; these are what a sweep culled by 32-row
    group boxes over a Morton-sorted table, as K4's is, would test
    (``mega_reference``'s counts)."""
    tab = table[table[:, 12] > 0].double()
    tab = tab[torch.from_numpy(morton_order(tab[:, 13:16].cpu().numpy()))
              .to(tab.device)]
    ic = tab[:, :6]                         # ic00 ic11 ic22 ic01 ic02 ic12
    a = torch.stack([ic[:, [0, 3, 4]], ic[:, [3, 1, 5]], ic[:, [4, 5, 2]]],
                    dim=1)
    half = R_CUT * torch.linalg.inv(a).diagonal(dim1=1, dim2=2).clamp(
        min=0.0).sqrt()
    pad = (0, 0, 0, -tab.shape[0] % GROUP)
    lo = F.pad((tab[:, 13:16] - half).float(), pad, value=math.inf)
    hi = F.pad((tab[:, 13:16] + half).float(), pad, value=-math.inf)
    first = torch.arange(0, tab.shape[0], GROUP, device=tab.device)
    return (_union_boxes(lo, hi, GROUP),
            torch.clamp(tab.shape[0] - first, max=GROUP))


def _count_pairs(counts, table, boxes, o, d, xi, alive, scattered, t_sc,
                 lights):
    """Adds one bounce's work to ``counts`` (see ``mega_reference``);
    ``boxes`` is ``group_boxes(table)``."""
    col = lambda f: table[:, f:f + 1]
    ray = [v[:, k][None, :] for v in (o, d) for k in range(3)]
    crossed = _interval(col, *ray, *_coeffs(col, *ray))[-1].sum(0)
    p, w, tmax, *_ = _nee_ray(ray, t_sc[None, :],
                              *(xi[:, k][None, :] for k in range(1, 5)),
                              lights)
    t0, t1, _, ok = _interval(col, *p, *w, *_coeffs(col, *p, *w))
    nee = (ok & (torch.minimum(t1, tmax) > t0)).sum(0)
    box, rows = boxes
    ext_adm = chunk_box_hits_reference(box, o, d)
    nee_adm = chunk_box_hits_reference(box, torch.cat(p).T, torch.cat(w).T,
                                       tmax[0])
    sc = alive & scattered
    counts["groups"] = box.shape[0]
    for key, v in (("evals", alive), ("scattered", sc),
                   ("ext_pairs", torch.where(alive, crossed, 0)),
                   ("solve_pairs", torch.where(sc, crossed, 0)),
                   ("nee_pairs", torch.where(sc, nee, 0)),
                   ("ext_groups", ext_adm.sum(1) * alive),
                   ("ext_rows", (ext_adm * rows).sum(1) * alive),
                   ("nee_groups", nee_adm.sum(1) * sc),
                   ("nee_rows", (nee_adm * rows).sum(1) * sc)):
        counts[key] = counts.get(key, 0) + int(v.sum())


def mega_reference(cam_vec, table, ids, cfg, lights, env, pinhole: bool,
                   counts: dict | None = None):
    """Plain version of K1.  ids [B] int32 pixel ids; cfg a RenderConfig.
    Returns (radiance sums over the spp samples [B,3], bounce evaluations
    per pixel [B] int32).  ``counts``, a dict if given, receives the work
    the paths need, for measurements: 'evals' bounce evaluations,
    'scattered' those that scatter (each sweeps a shadow ray and solves),
    'ext_pairs' the pairs their extension rays cross, 'solve_pairs' those
    of the rays that scatter, 'nee_pairs' the pairs the shadow rays'
    segments cross; 'groups' the table's ``group_boxes``, 'ext_groups' and
    'nee_groups' those the extension rays and the shadow rays' segments
    meet, 'ext_rows' and 'nee_rows' the valid rows of those groups."""
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
    boxes = None if counts is None else group_boxes(table)
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
        if counts is not None:
            _count_pairs(counts, table, boxes, o, d, xi, alive, scattered,
                         t_sc, lights)

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


def mega_call(cam_vec, table, ids, cfg, lights, env, pinhole: bool,
              phases=None):
    """Radiance sums [B,3] and bounce evaluations [B] for the spp samples
    of each pixel id in ``ids``; the arguments of ``mega_reference``.  A CPU
    tensor takes the plain version; a CUDA tensor launches K1 or raises.
    ``phases``, an int64 [4, 3] CUDA tensor if given, receives the
    instrumented kernel's phase counters (added to it; MEGA_PHASES)."""
    if ids.device.type == "cpu":
        if phases is not None:
            raise ValueError("phases: K1's counters exist only on the card")
        return mega_reference(cam_vec, table, ids, cfg, lights, env, pinhole)
    dev = ids.device
    b = ids.shape[0]
    _build.check(cam_vec, "cam_vec", torch.float32, (16,), dev)
    _build.check(ids, "ids", torch.int32, (b,), dev)
    check_table(table, dev)
    check_lights(lights, env, dev)
    if phases is not None:
        _build.check(phases, "phases", torch.int64,
                     (len(MEGA_PHASES), 3), dev)
    out_rad = torch.empty((b, 3), dtype=torch.float32, device=dev)
    out_count = torch.empty(b, dtype=torch.int32, device=dev)
    n_lights = lights.shape[0]
    nee_w = float(np.float32(INV_4PI * (n_lights + 1 if n_lights else 1)))
    seed_mix, seed_raw = seed_words(cfg.seed)
    per_sm, sms = resident_blocks(dev)
    _build.launch(
        "gvr_mega", _build.ptr(cam_vec), _build.ptr(table), table.shape[0],
        _build.ptr(ids), b, _build.ptr(lights), n_lights, _build.ptr(env),
        nee_w, cfg.width, cfg.height, cfg.spp, strat_n(cfg.spp),
        ctypes.c_uint32(seed_mix), ctypes.c_uint32(seed_raw),
        cfg.solver_iters, int(cfg.solver_finisher), cfg.min_scatter,
        cfg.rr_cap, cfg.rr_tail_after, cfg.rr_cap_tail, cfg.max_bounces,
        int(pinhole), pool_pixels(cfg.spp, b, per_sm * sms),
        _build.ptr(out_rad), _build.ptr(out_count),
        None if phases is None else _build.ptr(phases), device=dev)
    mega_call.launches += 1
    return out_rad, out_count


mega_call.launches = 0
