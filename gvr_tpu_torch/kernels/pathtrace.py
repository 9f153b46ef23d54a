"""One fused path-tracing bounce: the table, the plain version and the CUDA
kernel (K2).

Replaces ``gvr_tpu/kernels/pathtrace.py:465 _bounce_call`` (body
``_make_kernel`` :434 around ``_bounce_core`` :272).  Per ray: quadratic
coefficients against every Gaussian, the 3-sigma clipped interval, the
closed-form erf optical depth, the scatter test against -log(1-u),
``solver_iters`` steps of bracketed Newton + Illinois, the optional erfinv
finisher, the mixture albedo at the scatter point and NEE (the env or one
of L lights) with one shadow-ray optical depth.

Plain version (``bounce_core_reference``): the TPU kernel's math on
[N, B] tensors (Gaussians x rays), step by step, with torch.erf/erfinv.

Kernel (``csrc/bounce.cuh`` device function, whose pair sweep, solve and
shadow-ray depth the megakernel shares; ``csrc/kernels.cu:gvr_bounce``
launcher): one thread per ray.  ``bounce_step`` launches it once a
wavefront iteration on the step wavefront
(``integrators/multiscatter.wavefront_pixels_step``, under
``RenderConfig(wavefront='step')``).  On the H100 it is bound by
arithmetic and the special-function units (erf/exp per pair per pass), not
by memory: the table is 64 B per Gaussian and stays in the
read-only cache.  Its first pass over all rows runs a division-free
pre-test (``may_cross_reference`` is its plain version) before each pair
test, and keeps the pairs the ray crosses in shared memory (the first
few whole, the rows of the rest), so the Newton, finisher and albedo
passes touch only those instead of holding [N, B] arrays.
"""

from __future__ import annotations

import math

import torch

from gvr_tpu_torch.kernels import _build
from gvr_tpu_torch.ops.solvers import illinois_update
from gvr_tpu_torch.scene.gaussians import R_CUT, GaussianMixture

SQRT_HALF = 0.7071067811865476
FOUR_PI = 4.0 * math.pi
BIG = 1e30
# The JAX package's dispatch thresholds, kept so a scene takes the same
# engine in both packages until they are measured on the card.
MAX_PALLAS_GAUSSIANS = 256
MEGA_MAX_GAUSSIANS = 2048
TABLE_COLS = 16
# A ray's crossed pairs that K1's and K2's solve passes walk by list, and
# of those the ones kept whole in shared memory (csrc/bounce.cuh)
MAX_HITS, PAIR_CACHE = 32, 2
# The pre-test's margin (csrc/bounce.cuh PRE_REL, may_cross_reference)
PRE_REL = 1e-5


def padded_n(n: int) -> int:
    return max(8, ((n + 7) // 8) * 8)


def pack_table(gmm: GaussianMixture) -> torch.Tensor:
    """[Np, 16] float32 feature table, Np = N rounded up to 8:
    0-5 icpack, 6-8 q = inv_cov @ mean, 9 c0, 10 density * norm,
    11 albedo, 12 valid, 13-15 mean.  Padding rows are an identity
    quadratic with valid = 0 (never hit)."""
    n = gmm.n
    rows = torch.cat([
        gmm.icpack(), gmm.qvec(), gmm.c0()[:, None],
        (gmm.density * gmm.norm)[:, None], gmm.albedo[:, None],
        torch.ones((n, 1), dtype=torch.float32, device=gmm.mean.device),
        gmm.mean], dim=1)
    tab = torch.zeros((padded_n(n), TABLE_COLS), dtype=torch.float32,
                      device=gmm.mean.device)
    tab[:n] = rows
    tab[n:, 0:3] = 1.0
    return tab


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


def may_cross_reference(table, o, d) -> torch.Tensor:
    """The kernels' division-free pre-test in plain torch (csrc/bounce.cuh
    ``may_cross``, which K1, K2, K4, K5 and K7 run before ``interval``):
    [N, B] bool, false only where the ray's line misses the R_CUT
    ellipsoid by the PRE_REL margin.  It must pass every pair that
    ``interval`` finds ok."""
    col = lambda f: table[:, f:f + 1]
    ray = [v[:, k][None, :] for v in (o, d) for k in range(3)]
    ic = [col(k) for k in range(6)]         # ic00 ic11 ic22 ic01 ic02 ic12
    mat = lambda x, y, z: (ic[0] * x + ic[3] * y + ic[4] * z,
                           ic[3] * x + ic[1] * y + ic[5] * z,
                           ic[4] * x + ic[5] * y + ic[2] * z)
    w = [ray[k] - col(13 + k) for k in range(3)]
    ad = mat(*ray[3:])
    aw = mat(*w)
    a = sum(ray[3 + k] * ad[k] for k in range(3))
    bh = sum(w[k] * ad[k] for k in range(3))
    c = sum(w[k] * aw[k] for k in range(3))
    ac, b2 = a * c, bh * bh
    return ac - b2 - R_CUT * R_CUT * a <= PRE_REL * (ac + b2)


def _tau_nee(col, px, py, pz, wx, wy, wz, tmax):
    """Clipped optical depth along shadow/env rays: [1, B]."""
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


def _finisher_root(tgt, tau_done, n_act, nxt, prv, sa1, zoff1, pref1,
                   erflo1, t0_1, t1_1):
    """Closed-form root where exactly one interval is active at the iterate
    (distance_solvers.h:176-186); returns (t_a, fin)."""
    arg = (tgt - tau_done) / torch.clamp(pref1, min=1e-30) + erflo1
    one_eps = 1.0 - 1e-6
    t_a = ((torch.erfinv(torch.clamp(arg, -one_eps, one_eps)) / SQRT_HALF
            - zoff1) / torch.clamp(sa1, min=1e-30))
    fin = ((n_act == 1.0) & (arg > -one_eps) & (arg < one_eps)
           & (t_a >= torch.maximum(t0_1, prv))
           & (t_a <= torch.minimum(t1_1, nxt)))
    return t_a, fin


def _pairs(col, ox, oy, oz, dx, dy, dz):
    """The first pass's per-(Gaussian, ray) quantities, each [N, B]:
    (sa, zoff, peak, pref, erf_lo, tau_i, t0m, t1m, ok), with pref and
    tau_i 0, t0m BIG and t1m 0 where the pair is not ok."""
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


def _newton(pairs, tau_tot, t_lo, t_hi, tgt, solver_iters: int, step):
    """``solver_iters`` bracketed Newton steps ``step`` toward tau = tgt
    from the bracket midpoint; returns the root clamped to [t_lo, t_hi]
    ([1, B])."""
    sa, zoff, peak, pref, erf_lo, tau_i, t0m, t1m, ok = pairs
    lo, hi, flo = t_lo, t_hi, -tgt
    fhi = torch.clamp(tau_tot - tgt, min=1e-12)
    t = 0.5 * (t_lo + t_hi)
    for _ in range(solver_iters):
        z = sa * t + zoff                                   # [N, B]
        ez = torch.exp(-0.5 * z * z)
        seg = torch.where(t >= t1m, tau_i,
                          pref * (torch.erf(z * SQRT_HALF) - erf_lo))
        seg = torch.where(t > t0m, seg, 0.0)
        inside = (t >= t0m) & (t <= t1m)
        sig = torch.where(inside & ok, peak * ez, 0.0).sum(0, keepdim=True)
        lo, hi, flo, fhi, t = step(lo, hi, flo, fhi, t,
                                   seg.sum(0, keepdim=True) - tgt, sig)
    return torch.minimum(torch.maximum(t, t_lo), t_hi)


def _albedo(col, pairs, t_sc):
    """Mixture albedo at t_sc (gmm.h:128-143), [1, B]."""
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
    """NEE to the env or one light (integrator.h:657-683) from o + t_sc d:
    (p, w, tmax, is_env, rad [3, 1, B], inv_d2), each [1, B] unless
    named; Li = exp(-tau(p, w, tmax)) * (4 pi env if is_env else rad *
    inv_d2)."""
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
                torch.zeros((3,) + tuple(t_sc.shape), device=t_sc.device),
                torch.zeros_like(t_sc))
    is_env = u_nee < 1.0 / (n_lights + 1)
    lidx = torch.clamp((u_light * n_lights).to(torch.int64), 0,
                       n_lights - 1)[0]
    row = lights[lidx].T[:, None, :]                      # [6, 1, B]
    to = [row[k] - p[k] for k in range(3)]
    dist = torch.sqrt(torch.clamp(to[0] * to[0] + to[1] * to[1]
                                  + to[2] * to[2], min=1e-24))
    inv_dist = 1.0 / dist
    w = tuple(torch.where(is_env, e[k], to[k] * inv_dist) for k in range(3))
    return (p, w, torch.where(is_env, 1e8, dist), is_env, row[3:6],
            inv_dist * inv_dist)


def _li(tr, is_env, rad, inv_d2, env):
    """[B, 3] NEE radiance from the shadow ray's transmittance tr [1, B]."""
    return torch.stack([torch.where(is_env, tr * (env[c] * FOUR_PI),
                                    tr * rad[c] * inv_d2)[0]
                        for c in range(3)], dim=-1)


def bounce_core_reference(table, o, d, xi, lights, env,
                          solver_iters: int = 12, finisher: bool = False):
    """Plain version of K2 on [N, B] tensors.

    table [Np,16]; o, d [B,3]; xi [B,>=5] uniforms (target, NEE choice,
    light index, env direction x2); lights [L,6]; env [3].
    Returns (t_sc [B], scattered bool [B], albedo [B], li [B,3],
    tau_tot [B], fin bool [B])."""
    bounce_core_reference.launches += 1
    col = lambda f: table[:, f:f + 1]                      # [N, 1]
    ray = [v[:, k][None, :] for v in (o, d) for k in range(3)]  # [1, B]
    u_tau, u_nee, u_light, u_env1, u_env2 = (xi[:, k][None, :]
                                             for k in range(5))
    pairs = _pairs(col, *ray)
    sa, zoff, _, pref, erf_lo, tau_i, t0m, t1m, ok = pairs
    tau_tot = tau_i.sum(dim=0, keepdim=True)                # [1, B]
    t_hi = t1m.amax(dim=0, keepdim=True)
    t_lo = torch.minimum(t0m.amin(dim=0, keepdim=True), t_hi)

    target = -torch.log(torch.clamp(1.0 - u_tau, min=1e-12))
    scattered = tau_tot > target
    tgt = torch.minimum(target, tau_tot * 0.999999)
    t_sc = _newton(pairs, tau_tot, t_lo, t_hi, tgt, solver_iters,
                   illinois_update)

    if finisher:
        act = (t_sc > t0m) & (t_sc < t1m) & ok
        done = ok & (t1m <= t_sc)
        pick = lambda x: torch.where(act, x, 0.0).sum(0, keepdim=True)
        t_a, fin = _finisher_root(
            tgt, torch.where(done, tau_i, 0.0).sum(0, keepdim=True),
            act.to(torch.float32).sum(0, keepdim=True),
            torch.where(ok & (t0m > t_sc), t0m, BIG).amin(0, keepdim=True),
            torch.where(done, t1m, 0.0).amax(0, keepdim=True),
            pick(sa), pick(zoff), pick(pref), pick(erf_lo), pick(t0m),
            pick(t1m))
        t_sc = torch.where(fin, t_a, t_sc)
    else:
        fin = torch.zeros_like(scattered)

    albedo = _albedo(col, pairs, t_sc)
    p, w, tmax, is_env, rad, inv_d2 = _nee_ray(ray, t_sc, u_nee, u_light,
                                               u_env1, u_env2, lights)
    tr = torch.exp(-_tau_nee(col, *p, *w, tmax))
    return (t_sc[0], scattered[0], albedo[0], _li(tr, is_env, rad, inv_d2,
                                                  env),
            tau_tot[0], fin[0])


bounce_core_reference.launches = 0


def bounce_step(table, o, d, xi, lights, env, solver_iters: int = 12,
                finisher: bool = False):
    """One fused bounce for a ray batch; the arguments and results of
    ``bounce_core_reference``.  A CPU tensor takes the plain version; a
    CUDA tensor launches K2 or raises."""
    if table.device.type == "cpu":
        return bounce_core_reference(table, o, d, xi, lights, env,
                                     solver_iters, finisher)
    dev = table.device
    b = o.shape[0]
    xi5 = xi[:, :5].contiguous()
    check_table(table, dev)
    _build.check(o, "o", torch.float32, (b, 3), dev)
    _build.check(d, "d", torch.float32, (b, 3), dev)
    _build.check(xi5, "xi", torch.float32, (b, 5), dev)
    check_lights(lights, env, dev)
    out = torch.empty((8, b), dtype=torch.float32, device=dev)
    _build.launch(
        "gvr_bounce", _build.ptr(table), table.shape[0], _build.ptr(o),
        _build.ptr(d), _build.ptr(xi5), b, _build.ptr(lights),
        lights.shape[0], _build.ptr(env), solver_iters, int(finisher),
        _build.ptr(out), device=dev)
    bounce_step.launches += 1
    return (out[0], out[1] > 0.5, out[2], out[3:6].T, out[6], out[7] > 0.5)


bounce_step.launches = 0


def check_table(table: torch.Tensor, dev) -> None:
    """The kernels read table rows as float4: [Np, 16] float32 on
    ``dev``, contiguous, 16-byte aligned, at most MEGA_MAX_GAUSSIANS
    rows."""
    _build.check(table, "table", torch.float32, (None, TABLE_COLS), dev)
    if table.data_ptr() % 16:
        raise ValueError("table: data pointer is not 16-byte aligned")
    if not 0 < table.shape[0] <= MEGA_MAX_GAUSSIANS:
        raise ValueError(f"table: {table.shape[0]} rows, the kernels take "
                         f"1..{MEGA_MAX_GAUSSIANS}")


def check_lights(lights: torch.Tensor, env: torch.Tensor, dev) -> None:
    _build.check(lights, "lights", torch.float32, (None, 6), dev)
    _build.check(env, "env", torch.float32, (3,), dev)
