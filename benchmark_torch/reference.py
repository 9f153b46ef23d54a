"""The plain reference of a multiscatter render, in plain torch.

It imports nothing of the program: every function here is a copy of the
port's plain versions as they stand (``kernels/megatrace.mega_reference``
around ``kernels/pathtrace.bounce_core_reference``, the counter hash of
``kernels/rng.uniform_cols``, ``cameras.camera_rays``, ``strat_uv``,
``ops/solvers.illinois_update``, and ``illinois_update_inset``, the
solve of ``kernels/pathtrace_big.big_stage1_reference``), written for any
floating dtype:

* float64: the reference that decides ``correct``;
* bfloat16: the control, the same estimator one precision step below the
  float32 that the configurations state;
* float32: the program's own precision, which the work count follows.

A path is one lane: (pixel, sample) from its camera ray to its end, its
draws keyed by (pixel, sample, bounce, seed) as the program keys them, so
a path here is the program's path, up to rounding.  A pixel's radiance is
the sum of its samples' radiance in sample order over spp.  The table and
the camera are built here from the scene text's numbers, never taken
from the program.

``render_pixels(..., counts=dict)`` also counts the work the paths need
(``count_bounce``: the copy of ``megatrace._count_pairs``); ``work.py``
turns the count into a bound.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

R_CUT = 3.0
SQRT_HALF = 0.7071067811865476
FOUR_PI = 4.0 * math.pi
INV_4PI = 1.0 / FOUR_PI
BIG = 1e30
TABLE_COLS = 16
JITTER_TAG = 0x7FFF0000
MASK = 0xFFFFFFFF
_M1, _M2, _M3 = 0x9E3779B9, 0x21F0AAAD, 0x735A2D97
# group boxes of the work count (pathtrace_big.GROUP, BOX_REL, BOX_ABS,
# EMPTY_BOX)
GROUP = 32
BOX_REL, BOX_ABS, EMPTY_BOX = 1e-3, 1e-4, 1e30
# [Gaussians x lanes] elements of one block of lanes
BLOCK_ELEMS = 1 << 24

# RenderConfig's defaults, which every cell renders with, and K1's solve
# (a cell's ``reference`` overrides them: big-N's falsi_inset is 0.05)
PATH_DEFAULTS = dict(min_scatter=5, rr_cap=0.9, rr_tail_after=16,
                     rr_cap_tail=0.5, max_bounces=64, solver_iters=12,
                     falsi_inset=0.0)


# ---- the scene's numbers and the table ------------------------------------

def parse_scene(text: str) -> dict:
    """Lights [L, 6] and the Gaussians' mean [N, 3], cov [N, 3, 3],
    density [N], albedo [N] from GMM scene text, float64 numpy, by the
    text format's rules ('l' and 'g' lines, floats read as a prefix)."""
    lights, rows = [], []
    for line in text.splitlines():
        parts = line.split()
        if not parts or parts[0] not in ("l", "g"):
            continue
        vals = []
        for v in parts[1:]:
            try:
                vals.append(float(v))
            except ValueError:
                break
        if parts[0] == "l" and len(vals) >= 6:
            lights.append(vals[:6])
        elif parts[0] == "g" and len(vals) >= 11:
            rows.append(vals[:11])
    g = np.asarray(rows, np.float64).reshape(-1, 11)
    c = g[:, 3:9]
    cov = np.stack([c[:, [0, 1, 2]], c[:, [1, 3, 4]], c[:, [2, 4, 5]]],
                   axis=1)
    return dict(lights=np.asarray(lights, np.float64).reshape(-1, 6),
                mean=g[:, 0:3], cov=cov, density=g[:, 9], albedo=g[:, 10])


def gaussian_table(scene: dict, dtype, device) -> torch.Tensor:
    """[N, 16] table in ``dtype`` (the layout of the program's
    ``pack_table``: icpack, inv_cov @ mean, mean^T inv_cov mean,
    density * norm, albedo, valid, mean), computed in float64 from the
    covariances by inversion."""
    inv = np.linalg.inv(scene["cov"])
    mean = scene["mean"]
    q = np.einsum("nij,nj->ni", inv, mean)
    norm = (2.0 * math.pi) ** -1.5 / np.sqrt(np.linalg.det(scene["cov"]))
    tab = np.concatenate([
        inv[:, [0, 1, 2, 0, 0, 1], [0, 1, 2, 1, 2, 2]], q,
        np.einsum("ni,ni->n", q, mean)[:, None],
        (scene["density"] * norm)[:, None], scene["albedo"][:, None],
        np.ones((mean.shape[0], 1)), mean], axis=1)
    return torch.as_tensor(tab, device=device).to(dtype)


def pinhole(position, lookat, fov_deg: float, dtype, device) -> dict:
    """The pinhole camera's frame (``cameras.make_frame``): position, right,
    up, view direction and focal 1 / tan(fov / 2), the fov taken as the
    program takes it, a float32 value."""
    pos = torch.as_tensor(position, dtype=torch.float64)
    view = torch.as_tensor(lookat, dtype=torch.float64) - pos
    view = view / torch.linalg.vector_norm(view)
    r = torch.linalg.cross(view, torch.tensor([0.0, 1.0, 0.0],
                                              dtype=torch.float64))
    if float(torch.linalg.vector_norm(r)) < 1e-6:
        r = torch.linalg.cross(view, torch.tensor([0.0, 0.0, 1.0],
                                                  dtype=torch.float64))
    right = r / torch.linalg.vector_norm(r)
    up = torch.linalg.cross(right, view)
    up = up / torch.linalg.vector_norm(up)
    fov = float(np.float32(math.radians(fov_deg)))
    cam = dict(position=pos, right=right, up=up, view_dir=view,
               focal=torch.tensor(1.0 / math.tan(0.5 * fov),
                                  dtype=torch.float64))
    return {k: v.to(device=device, dtype=dtype) for k, v in cam.items()}


# ---- the counter hash (kernels/rng.uniform_cols) ---------------------------

def _mul32(x, c: int):
    lo = x & 0xFFFF
    hi = x >> 16
    return (lo * c + (((hi * c) & 0xFFFF) << 16)) & MASK


def _mix32(x):
    x = (x + _M1) & MASK
    x = _mul32(x ^ (x >> 16), _M2)
    x = _mul32(x ^ (x >> 15), _M3)
    return x ^ (x >> 15)


def _mix32_int(x: int) -> int:
    x = (x + _M1) & MASK
    x = ((x ^ (x >> 16)) * _M2) & MASK
    x = ((x ^ (x >> 15)) * _M3) & MASK
    return x ^ (x >> 15)


def uniforms(pid, sample, bounce, n: int, seed: int, dtype):
    """[B, n] uniforms in [0, 1) of the keys (pid, sample, bounce) (int64
    tensors [B], or an int bounce) and ``seed``: the splitmix32 chain's
    23 high bits."""
    pid = pid & MASK
    s = sample & MASK
    b = (torch.full_like(pid, bounce & MASK) if isinstance(bounce, int)
         else bounce & MASK)
    seed_raw = seed & MASK
    seed_mix = _mix32_int(seed_raw)
    h1 = _mix32(_mul32(pid, 0x85EBCA6B) ^ _mul32(s, 0xC2B2AE35) ^ seed_mix)
    h2 = _mix32((_mul32(pid ^ 0xDEADBEEF, 0x9E3779B1)
                 + _mul32(s, 0x6C078965) + seed_raw) & MASK)
    b1 = _mix32(h1 ^ _mul32(b, 0x27D4EB2F))
    b2 = _mix32((h2 + _mul32(b, 0x41C64E6D)) & MASK)
    cols = [(_mix32(((b1 ^ ((0x165667B1 * (i + 1)) & MASK)) + b2) & MASK)
             >> 9).to(dtype) * (2.0 ** -23) for i in range(n)]
    return torch.stack(cols, dim=-1)


# ---- one bounce on [N, B] tensors (kernels/pathtrace) ----------------------

def _coeffs(col, ox, oy, oz, dx, dy, dz):
    ic0, ic1, ic2, ic3, ic4, ic5 = (col(i) for i in range(6))

    def bil(ux, uy, uz, vx, vy, vz):
        return (ux * vx * ic0 + uy * vy * ic1 + uz * vz * ic2
                + (ux * vy + uy * vx) * ic3
                + (ux * vz + uz * vx) * ic4
                + (uy * vz + uz * vy) * ic5)

    a = bil(dx, dy, dz, dx, dy, dz)
    d_q = dx * col(6) + dy * col(7) + dz * col(8)
    return a, 2.0 * (bil(ox, oy, oz, dx, dy, dz) - d_q)


def _interval(col, ox, oy, oz, dx, dy, dz, a, b):
    """(t0 clamped >= 0, t1, m2, ok), each [N, B]."""
    ic0, ic1, ic2, ic3, ic4, ic5 = (col(i) for i in range(6))
    a_s = torch.clamp(a, min=1e-30)
    t_star = -b / (2.0 * a_s)
    vx = ox - col(13) + t_star * dx
    vy = oy - col(14) + t_star * dy
    vz = oz - col(15) + t_star * dz
    m2 = (vx * vx * ic0 + vy * vy * ic1 + vz * vz * ic2
          + 2.0 * (vx * vy * ic3 + vx * vz * ic4 + vy * vz * ic5))
    m2 = torch.clamp(m2, min=0.0)
    gap = (R_CUT * R_CUT - m2) / a_s
    half = torch.sqrt(torch.where(gap > 0.0, gap, 0.0))
    t1 = t_star + half
    t0 = torch.clamp(t_star - half, min=0.0)
    ok = (gap > 0.0) & (t1 >= 0.0) & (col(12) > 0.0)
    return t0, t1, m2, ok


def _tau_nee(col, px, py, pz, wx, wy, wz, tmax):
    a, b = _coeffs(col, px, py, pz, wx, wy, wz)
    a_s = torch.clamp(a, min=1e-30)
    t0, t1, m2, ok = _interval(col, px, py, pz, wx, wy, wz, a, b)
    hi = torch.minimum(t1, tmax)
    ok = ok & (hi > t0)
    sa = torch.sqrt(a_s)
    zoff = b * (0.5 / sa)
    pref = col(10) * torch.exp(-0.5 * m2) * torch.sqrt(math.pi / (2.0 * a_s))
    f = lambda t: torch.erf((sa * t + zoff) * SQRT_HALF)
    seg = pref * (f(hi) - f(t0))
    return torch.where(ok, seg, 0.0).sum(dim=0, keepdim=True)


def _pairs(col, ox, oy, oz, dx, dy, dz):
    a, b = _coeffs(col, ox, oy, oz, dx, dy, dz)
    a_s = torch.clamp(a, min=1e-30)
    t0, t1, m2, ok = _interval(col, ox, oy, oz, dx, dy, dz, a, b)
    sa = torch.sqrt(a_s)
    zoff = b * (0.5 / sa)
    peak = col(10) * torch.exp(-0.5 * m2)
    pref = torch.where(ok, peak * torch.sqrt(math.pi / (2.0 * a_s)), 0.0)
    erf_lo = torch.erf((sa * t0 + zoff) * SQRT_HALF)
    erf_hi = torch.erf((sa * t1 + zoff) * SQRT_HALF)
    return (sa, zoff, peak, pref, erf_lo, pref * (erf_hi - erf_lo),
            torch.where(ok, t0, BIG), torch.where(ok, t1, 0.0), ok)


def _illinois(lo, hi, flo, fhi, t, f, sig, inset: float = 0.0):
    """One Newton + Illinois step (``ops/solvers.illinois_update``); with
    ``inset`` > 0 the big-N kernel's (``illinois_update_inset``): the
    falsi point kept ``inset`` of the bracket from its ends, and the
    Newton point taken without a finiteness test."""
    neg = f < 0.0
    flo = torch.where(neg, f, flo * 0.5)
    fhi = torch.where(neg, fhi * 0.5, f)
    lo = torch.where(neg, t, lo)
    hi = torch.where(neg, hi, t)
    t_n = t - f / torch.clamp(sig, min=1e-30)
    good = (t_n > lo) & (t_n < hi)
    if not inset:
        good = good & torch.isfinite(t_n)
    denom = fhi - flo
    t_f = hi - fhi * (hi - lo) / torch.where(denom.abs() > 1e-30, denom,
                                             1e-30)
    t_f = torch.minimum(torch.maximum(t_f, lo + inset * (hi - lo)),
                        hi - inset * (hi - lo))
    return lo, hi, flo, fhi, torch.where(good, t_n, t_f)


def _newton(pairs, tau_tot, t_lo, t_hi, tgt, solver_iters: int,
            inset: float = 0.0):
    sa, zoff, peak, pref, erf_lo, tau_i, t0m, t1m, ok = pairs
    lo, hi, flo = t_lo, t_hi, -tgt
    fhi = torch.clamp(tau_tot - tgt, min=1e-12)
    t = 0.5 * (t_lo + t_hi)
    for _ in range(solver_iters):
        z = sa * t + zoff
        ez = torch.exp(-0.5 * z * z)
        seg = torch.where(t >= t1m, tau_i,
                          pref * (torch.erf(z * SQRT_HALF) - erf_lo))
        seg = torch.where(t > t0m, seg, 0.0)
        inside = (t >= t0m) & (t <= t1m)
        sig = torch.where(inside & ok, peak * ez, 0.0).sum(0, keepdim=True)
        lo, hi, flo, fhi, t = _illinois(lo, hi, flo, fhi, t,
                                        seg.sum(0, keepdim=True) - tgt, sig,
                                        inset)
    return torch.minimum(torch.maximum(t, t_lo), t_hi)


def _albedo(col, pairs, t_sc):
    sa, zoff, peak, _, _, _, t0m, t1m, ok = pairs
    z = sa * t_sc + zoff
    inside = (t_sc >= t0m) & (t_sc <= t1m)
    rho = torch.where(inside & ok, peak * torch.exp(-0.5 * z * z), 0.0)
    s_sum = rho.sum(0, keepdim=True)
    sa_sum = (rho * col(11)).sum(0, keepdim=True)
    return torch.clamp(torch.where(
        s_sum > 1e-25, sa_sum / torch.where(s_sum > 1e-25, s_sum, 1.0), 0.0),
        0.0, 1.0)


def _nee_ray(ray, t_sc, u_nee, u_light, u_env1, u_env2, lights):
    """(p, w, tmax, is_env, rad [3, 1, B], inv_d2)."""
    ox, oy, oz, dx, dy, dz = ray
    p = (ox + t_sc * dx, oy + t_sc * dy, oz + t_sc * dz)
    theta = (2.0 * math.pi) * u_env1
    cphi = 1.0 - 2.0 * u_env2
    sphi = torch.sqrt(torch.clamp(1.0 - cphi * cphi, min=0.0))
    e = (sphi * torch.cos(theta), sphi * torch.sin(theta), cphi)
    n_lights = lights.shape[0]
    if n_lights == 0:
        return (p, e, torch.full_like(t_sc, 1e8),
                torch.ones(t_sc.shape, dtype=torch.bool, device=t_sc.device),
                torch.zeros((3,) + tuple(t_sc.shape), dtype=t_sc.dtype,
                            device=t_sc.device),
                torch.zeros_like(t_sc))
    is_env = u_nee < 1.0 / (n_lights + 1)
    lidx = torch.clamp((u_light * n_lights).to(torch.int64), 0,
                       n_lights - 1)[0]
    row = lights[lidx].T[:, None, :]
    to = [row[k] - p[k] for k in range(3)]
    dist = torch.sqrt(torch.clamp(to[0] * to[0] + to[1] * to[1]
                                  + to[2] * to[2], min=1e-24))
    inv_dist = 1.0 / dist
    w = tuple(torch.where(is_env, e[k], to[k] * inv_dist) for k in range(3))
    return (p, w, torch.where(is_env, 1e8, dist), is_env, row[3:6],
            inv_dist * inv_dist)


def bounce(table, o, d, xi, lights, env, solver_iters: int,
           falsi_inset: float = 0.0):
    """One bounce of rays o, d [B, 3] with draws xi [B, >= 5]: (t_sc [B],
    scattered [B], albedo [B], li [B, 3]), the program's
    ``bounce_core_reference`` without the finisher (off in every cell);
    ``falsi_inset`` 0.05 solves as big-N's ``big_stage1_reference``."""
    col = lambda f: table[:, f:f + 1]
    ray = [v[:, k][None, :] for v in (o, d) for k in range(3)]
    u_tau, u_nee, u_light, u_env1, u_env2 = (xi[:, k][None, :]
                                             for k in range(5))
    pairs = _pairs(col, *ray)
    tau_i, t0m, t1m = pairs[5], pairs[6], pairs[7]
    tau_tot = tau_i.sum(dim=0, keepdim=True)
    t_hi = t1m.amax(dim=0, keepdim=True)
    t_lo = torch.minimum(t0m.amin(dim=0, keepdim=True), t_hi)
    target = -torch.log(torch.clamp(1.0 - u_tau, min=1e-12))
    scattered = tau_tot > target
    tgt = torch.minimum(target, tau_tot * 0.999999)
    t_sc = _newton(pairs, tau_tot, t_lo, t_hi, tgt, solver_iters,
                   falsi_inset)
    albedo = _albedo(col, pairs, t_sc)
    p, w, tmax, is_env, rad, inv_d2 = _nee_ray(ray, t_sc, u_nee, u_light,
                                               u_env1, u_env2, lights)
    tr = torch.exp(-_tau_nee(col, *p, *w, tmax))
    li = torch.stack([torch.where(is_env, tr * (env[c] * FOUR_PI),
                                  tr * rad[c] * inv_d2)[0]
                      for c in range(3)], dim=-1)
    return t_sc[0], scattered[0], albedo[0], li


# ---- the work count (megatrace._count_pairs, group_boxes) ------------------

def morton_order(points: np.ndarray) -> np.ndarray:
    """Stable permutation of 3D points along a 30-bit Z-order curve."""
    p = np.asarray(points, np.float64)
    lo = p.min(axis=0)
    span = np.maximum(p.max(axis=0) - lo, 1e-12)
    q = np.clip((p - lo) / span * 1023.0, 0, 1023).astype(np.uint64)

    def spread(x):
        x = (x | (x << 16)) & np.uint64(0x030000FF)
        x = (x | (x << 8)) & np.uint64(0x0300F00F)
        x = (x | (x << 4)) & np.uint64(0x030C30C3)
        x = (x | (x << 2)) & np.uint64(0x09249249)
        return x

    code = spread(q[:, 0]) | (spread(q[:, 1]) << np.uint64(1)) \
        | (spread(q[:, 2]) << np.uint64(2))
    return np.argsort(code, kind="stable")


def _union_boxes(lo, hi, rows: int) -> torch.Tensor:
    lo = lo.view(-1, rows, 3).amin(1)
    hi = hi.view(-1, rows, 3).amax(1)
    scale = torch.maximum(lo.abs(), hi.abs()).amax(1, keepdim=True)
    margin = (BOX_REL * (hi - lo).amax(1, keepdim=True)
              + BOX_ABS * torch.clamp(scale, min=1.0))
    empty = ~torch.isfinite(lo).all(1, keepdim=True)
    boxes = torch.zeros((lo.shape[0], 8), dtype=lo.dtype, device=lo.device)
    boxes[:, 0:3] = torch.where(empty, EMPTY_BOX, lo - margin)
    boxes[:, 4:7] = torch.where(empty, -EMPTY_BOX, hi + margin)
    return boxes


def group_boxes(table) -> tuple:
    """(boxes [K, 8] float32, valid rows [K]) of the table's valid rows in
    the Morton order of their means, GROUP rows a group, each box the
    union of its rows' R_CUT ellipsoid boxes, widened."""
    tab = table[table[:, 12] > 0].double()
    tab = tab[torch.from_numpy(morton_order(tab[:, 13:16].cpu().numpy()))
              .to(tab.device)]
    ic = tab[:, :6]
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


def box_hits(boxes, o, d, tmax=None) -> torch.Tensor:
    """[B, K] bool: whether the segment [0, tmax] of each ray meets each
    box (the kernels' slab test)."""
    lo, hi = boxes[None, :, 0:3], boxes[None, :, 4:7]
    o, d = o[:, None, :], d[:, None, :]
    flat = d.abs() < 1e-30
    inv = 1.0 / torch.where(flat, 1.0, d)
    ta, tb = (lo - o) * inv, (hi - o) * inv
    pos = inv >= 0.0
    near = torch.where(flat, 0.0, torch.where(pos, ta, tb))
    far = torch.where(flat, torch.where((o >= lo) & (o <= hi),
                                        float("inf"), -BIG),
                      torch.where(pos, tb, ta)).amin(-1)
    if tmax is not None:
        far = torch.minimum(far, tmax[:, None])
    return torch.clamp(near.amax(-1), min=0.0) <= far


def count_bounce(counts, table, boxes, o, d, xi, alive, scattered, t_sc,
                 lights):
    """Adds one bounce's work to ``counts``: 'evals' bounce evaluations,
    'scattered' those that scatter, 'ext_pairs' the pairs their extension
    rays cross, 'solve_pairs' those of the rays that scatter, 'nee_pairs'
    the pairs the shadow rays' segments cross, 'groups' the table's
    groups, 'ext_groups'/'nee_groups' the groups the rays meet and
    'ext_rows'/'nee_rows' those groups' valid rows."""
    col = lambda f: table[:, f:f + 1]
    ray = [v[:, k][None, :] for v in (o, d) for k in range(3)]
    crossed = _interval(col, *ray, *_coeffs(col, *ray))[-1].sum(0)
    p, w, tmax, *_ = _nee_ray(ray, t_sc[None, :],
                              *(xi[:, k][None, :] for k in range(1, 5)),
                              lights)
    t0, t1, _, ok = _interval(col, *p, *w, *_coeffs(col, *p, *w))
    nee = (ok & (torch.minimum(t1, tmax) > t0)).sum(0)
    box, rows = boxes
    ext_adm = box_hits(box, o, d)
    nee_adm = box_hits(box, torch.cat(p).T, torch.cat(w).T, tmax[0])
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


# ---- the render of a pixel sample -------------------------------------------

def _strat_n(spp: int) -> int:
    n = max(int(spp ** 0.5), 1)
    return n if n * n == spp else 1


def _camera_rays(cam, u01, v01):
    u = 1.0 - u01 * 2.0
    v = v01 * 2.0 - 1.0
    origin = cam["position"] + u[:, None] * cam["right"] \
        + v[:, None] * cam["up"]
    d = cam["position"] + cam["focal"] * cam["view_dir"] - origin
    return origin, d / torch.linalg.vector_norm(d, dim=-1, keepdim=True)


def render_pixels(table, lights, env, cam, width: int, height: int,
                  spp: int, seed: int, ids, counts: dict | None = None,
                  path: dict | None = None) -> torch.Tensor:
    """Mean radiance [P, 3] of pixel ids [P] (int64, on the table's
    device) in the table's dtype: every (pixel, sample) path traced on
    its own lane to its end.  ``lights`` [L, 6] and ``env`` [3] in that
    dtype; ``cam`` from ``pinhole``; ``path`` overrides PATH_DEFAULTS.
    ``counts``, a dict if given, receives the work the paths need
    (``count_bounce``)."""
    pc = dict(PATH_DEFAULTS, **(path or {}))
    dt, dev = table.dtype, table.device
    n_strat = _strat_n(spp)
    w_ne = float(lights.shape[0] + 1) if lights.shape[0] else 1.0
    boxes = None if counts is None else group_boxes(table)
    p = ids.shape[0]
    lane_pid = ids.repeat_interleave(spp)
    lane_s = torch.arange(spp, device=dev).repeat(p)
    rad = torch.zeros((p * spp, 3), dtype=dt, device=dev)
    block = max(256, BLOCK_ELEMS // max(table.shape[0], 1))
    for start in range(0, p * spp, block):
        lanes = torch.arange(start, min(start + block, p * spp), device=dev)
        pid, s = lane_pid[lanes], lane_s[lanes]
        jit = uniforms(pid, s, JITTER_TAG, 2, seed, dt)
        x, y = pid % width, pid // width
        sx, sy = (s % n_strat).to(dt), ((s // n_strat) % n_strat).to(dt)
        u01 = (x.to(dt) + (sx + jit[:, 0]) / n_strat) / width
        v01 = (y.to(dt) + (sy + jit[:, 1]) / n_strat) / height
        o, d = _camera_rays(cam, u01, v01)
        thr = torch.ones((lanes.shape[0], 3), dtype=dt, device=dev)
        for b in range(pc["max_bounces"]):
            if lanes.numel() == 0:
                break
            xi = uniforms(pid, s, b, 9, seed, dt)
            t_sc, scattered, albedo, li = bounce(table, o, d, xi, lights,
                                                 env, pc["solver_iters"],
                                                 pc["falsi_inset"])
            if counts is not None:
                count_bounce(counts, table, boxes, o, d, xi,
                             torch.ones_like(scattered), scattered, t_sc,
                             lights)
            rad[lanes] += torch.where(
                scattered[:, None],
                thr * (albedo * (INV_4PI * w_ne))[:, None] * li,
                thr * env[None, :])
            thr_n = thr * albedo[:, None]
            alive = scattered
            if b >= pc["min_scatter"]:
                cap = pc["rr_cap_tail"] if b >= pc["rr_tail_after"] \
                    else pc["rr_cap"]
                rr = torch.clamp(thr_n.amax(dim=-1), max=cap)
                killed = xi[:, 5] > rr
                thr_n = torch.where(killed[:, None], thr_n,
                                    thr_n / torch.clamp(rr, min=1e-12)[:, None])
                alive = alive & ~killed
            keep = torch.nonzero(alive).squeeze(1)
            pos = o + t_sc[:, None] * d
            theta = (2.0 * math.pi) * xi[:, 6]
            cphi = 1.0 - 2.0 * xi[:, 7]
            sphi = torch.sqrt(torch.clamp(1.0 - cphi * cphi, min=0.0))
            new_d = torch.stack([sphi * torch.cos(theta),
                                 sphi * torch.sin(theta), cphi], dim=-1)
            lanes, pid, s = lanes[keep], pid[keep], s[keep]
            o, d, thr = pos[keep], new_d[keep], thr_n[keep]
    return rad.view(p, spp, 3).sum(dim=1) / spp
