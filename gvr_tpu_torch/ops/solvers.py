"""Free-flight distance solvers: invert tau(t) = target along rays.

Counterpart of ``gvr_tpu/ops/solvers.py:43-283`` (reference
``distance_solvers.h``, the segment walk of ``integrator.h:422-498`` and
the single-Gaussian inverse of ``gaussian.h:235-297``).  The optical depth
of the mixture up to t (``ops/transmittance.tau_up_to``) is the monotone
function the reference's event walk integrates, so it is inverted over the
whole ray with a fixed number of bracketed steps:

* NEWTON: Newton with the Illinois (regula-falsi) fallback;
* BISECTION: plain bisection (distance_solvers.h:25-57);
* ANALYTIC_NEWTON / ANALYTIC_BISECTION: the same iterate, then the erfinv
  finisher where the root lies in one Gaussian's interval (when
  ``finisher``) and the closed form on rays that hit one Gaussian;
* UNIFORM: a uniform sample inside the event segment that holds the root
  (distance_solvers.h:132-137).

``illinois_update`` is the one copy of the Newton + Illinois step in this
package, used by these solvers, the plain bounce (``kernels/pathtrace``)
and the grid solve, and mirrored line for line by ``illinois_update`` in
``csrc/bounce.cuh``.  ``illinois_update_inset`` is the step the JAX
package's big-N kernel writes out for itself
(``gvr_tpu/kernels/pathtrace_big.py:174-198``), mirrored by
``csrc/big.cuh``.  ``solve_conditional_free_flight`` is the
differentiable solve of the inverse renderer, its gradient by the implicit
function theorem.
"""

from __future__ import annotations

import torch

from gvr_tpu_torch.config import Solver
from gvr_tpu_torch.ops.gaxis import gmax, gmin, gsum
from gvr_tpu_torch.ops.transmittance import (RayGaussians, any_hit,
                                             far_bound, sigma_t_at,
                                             tau_total, tau_up_to)

NO_SCATTER = -1.0


def illinois_update(lo, hi, flo, fhi, t, f, sig):
    """One safeguarded Newton + Illinois step on tau(t) - target.

    f = tau(t) - target and sig = dtau/dt at t; returns the updated
    (lo, hi, flo, fhi, t_next).  A Newton step that leaves the bracket
    falls back to the regula-falsi secant with the stale side's f halved."""
    neg = f < 0.0
    flo = torch.where(neg, f, flo * 0.5)
    fhi = torch.where(neg, fhi * 0.5, f)
    lo = torch.where(neg, t, lo)
    hi = torch.where(neg, hi, t)
    t_n = t - f / torch.clamp(sig, min=1e-30)
    good = (t_n > lo) & (t_n < hi) & torch.isfinite(t_n)
    denom = fhi - flo
    t_f = hi - fhi * (hi - lo) / torch.where(denom.abs() > 1e-30, denom,
                                             1e-30)
    t_f = torch.minimum(torch.maximum(t_f, lo), hi)
    return lo, hi, flo, fhi, torch.where(good, t_n, t_f)


# The big-N kernel's regula-falsi clip: an inset of this fraction of the
# bracket at each end (the JAX package's round-2 FALSI_MARGIN, which its
# canonical step has since set to 0).
FALSI_INSET = 0.05


def illinois_update_inset(lo, hi, flo, fhi, t, f, sig):
    """``illinois_update`` as the big-N kernel K4 has it: the falsi point
    is clipped to [lo + 0.05 (hi - lo), hi - 0.05 (hi - lo)] and a Newton
    point is taken without a finiteness test.  This is a known difference
    between the JAX package's engines, kept so the port matches each."""
    neg = f < 0.0
    flo = torch.where(neg, f, flo * 0.5)
    fhi = torch.where(neg, fhi * 0.5, f)
    lo = torch.where(neg, t, lo)
    hi = torch.where(neg, hi, t)
    t_n = t - f / torch.clamp(sig, min=1e-30)
    good = (t_n > lo) & (t_n < hi)
    denom = fhi - flo
    t_f = hi - fhi * (hi - lo) / torch.where(denom.abs() > 1e-30, denom,
                                             1e-30)
    t_f = torch.minimum(torch.maximum(t_f, lo + FALSI_INSET * (hi - lo)),
                        hi - FALSI_INSET * (hi - lo))
    return lo, hi, flo, fhi, torch.where(good, t_n, t_f)


def _bracket(rg: RayGaussians):
    """(t_lo, t_hi, tau_max): a bracket of the root and the total optical
    depth."""
    t_lo = gmin(torch.where(rg.hit, rg.t0, torch.inf))
    t_hi = far_bound(rg)
    return torch.minimum(t_lo, t_hi), t_hi, tau_total(rg)


def _safeguarded_newton(rg: RayGaussians, target, t_lo, t_hi, iters: int,
                        use_newton: bool = True):
    """``iters`` bracketed steps toward tau_up_to(t) = target on
    [t_lo, t_hi], assuming f(t_lo) <= 0 <= f(t_hi): Newton + Illinois
    (``illinois_update``), or plain bisection with ``use_newton=False``
    (the reference's BISECTION ablation)."""
    lo, hi = t_lo, t_hi
    t = 0.5 * (lo + hi)
    flo = -target
    fhi = torch.clamp(tau_total(rg) - target, min=1e-12)
    for _ in range(iters):
        f = tau_up_to(rg, t) - target
        if use_newton:
            lo, hi, flo, fhi, t = illinois_update(lo, hi, flo, fhi, t, f,
                                                  sigma_t_at(rg, t))
            continue
        neg = f < 0.0
        flo = torch.where(neg, f, flo * 0.5)
        fhi = torch.where(neg, fhi * 0.5, f)
        lo = torch.where(neg, t, lo)
        hi = torch.where(neg, hi, t)
        t = 0.5 * (lo + hi)
    return torch.minimum(torch.maximum(t, t_lo), t_hi)


# arguments of erfinv are clipped to +-(1 - ONE_EPS)
ONE_EPS = 1.0 - 1e-6


def _erfinv_root(arg, fs, a, b):
    """The t of one Gaussian with erf(F(t)) = arg (arg clipped to
    +-ONE_EPS): (erfinv(arg) / fscale - B) / 2A.  torch.erfinv and XLA's
    erf_inv are different approximations, which differ by more than an ulp
    near the clip."""
    return ((torch.erfinv(torch.clamp(arg, -ONE_EPS, ONE_EPS))
             / torch.clamp(fs, min=1e-30) - b)
            / (2.0 * torch.clamp(a, min=1e-30)))


def _analytic_finisher(rg: RayGaussians, target, t):
    """The erfinv finisher (distance_solvers.h:176-186): where the iterate
    t lies inside exactly one Gaussian's interval, the rest of the target
    inverts in closed form, kept where no other interval opens or closes
    between the iterate and the closed-form root."""
    tt = t[..., None]
    act = rg.hit & (rg.t0 < tt) & (tt < rg.t1)
    n_act = gsum(act.to(torch.int32))
    done = rg.hit & (rg.t1 <= tt)
    tau_done = gsum(torch.where(done, rg.tau_i, 0.0))
    nxt = gmin(torch.where(rg.hit & (rg.t0 > tt), rg.t0, 3.4e38))
    prv = gmax(torch.where(done, rg.t1, 0.0))

    def pick(x):
        return gsum(torch.where(act, x, 0.0))

    arg = (target - tau_done) / torch.clamp(pick(rg.pref), min=1e-30) \
        + pick(rg.erf_lo)
    t_a = _erfinv_root(arg, pick(rg.fscale), pick(rg.a), pick(rg.b))
    fin = ((n_act == 1) & (arg > -ONE_EPS) & (arg < ONE_EPS)
           & torch.isfinite(t_a)
           & (t_a >= torch.maximum(pick(rg.t0), prv))
           & (t_a <= torch.minimum(pick(rg.t1), nxt)))
    return torch.where(fin, t_a, t)


def _analytic_single(rg: RayGaussians, target):
    """(t, valid): the closed-form inverse on rays that hit exactly one
    Gaussian (gaussian.h:235-297), whose coefficients the masked sums
    pick."""
    def pick(x):
        return gsum(torch.where(rg.hit, x, 0.0))

    pref, t0, t1 = pick(rg.pref), pick(rg.t0), pick(rg.t1)
    target_erf = target / torch.clamp(pref, min=1e-30) + pick(rg.erf_lo)
    t = _erfinv_root(target_erf, pick(rg.fscale), pick(rg.a), pick(rg.b))
    t = torch.where(target_erf >= ONE_EPS, t1, t)
    t = torch.where(target_erf <= -ONE_EPS, t0, t)
    valid = torch.isfinite(t) & (pref > 0.0)
    return torch.minimum(torch.maximum(t, t0), t1), valid


def _uniform_in_segment(rg: RayGaussians, target, u, iters: int = 24):
    """A uniform sample inside the critical segment
    (distance_solvers.h:132-137): the root of tau(t) = target by the
    bracketed Newton, then the nearest event times around it (the largest
    interval end at or before it, the smallest after it) by two masked
    reductions, and lo + u (hi - lo)."""
    t_lo, t_hi, _ = _bracket(rg)
    ts = _safeguarded_newton(rg, target, t_lo, t_hi, iters)[..., None]
    t0m = torch.where(rg.hit, rg.t0, torch.inf)
    t1m = torch.where(rg.hit, rg.t1, torch.inf)
    lo_t = torch.maximum(gmax(torch.where(t0m <= ts, t0m, -torch.inf)),
                         gmax(torch.where(t1m <= ts, t1m, -torch.inf)))
    hi_t = torch.minimum(gmin(torch.where(t0m > ts, t0m, torch.inf)),
                         gmin(torch.where(t1m > ts, t1m, torch.inf)))
    lo_t = torch.minimum(torch.maximum(lo_t, t_lo), t_hi)
    hi_t = torch.minimum(torch.maximum(hi_t, lo_t), t_hi)
    return lo_t + u * (hi_t - lo_t)


def sample_free_flight(rg: RayGaussians, target_tau, solver: Solver,
                       iters: int = 24, u_uniform=None,
                       finisher: bool = False):
    """(t_scatter, scattered): the distance with tau_up_to(t) = target_tau,
    NO_SCATTER where the ray's total optical depth is below the target
    (it escapes; integrator.h:497).  ``finisher`` gates the erfinv
    finisher of the analytic solvers (``cfg.solver_finisher``); their
    closed form on single-hit rays is always on.  UNIFORM needs
    ``u_uniform``, one uniform a ray."""
    t_lo, t_hi, tau_max = _bracket(rg)
    scattered = any_hit(rg) & (tau_max > target_tau)
    # a target the escaped rays cannot reach keeps the solve well posed
    tgt = torch.minimum(target_tau, tau_max * 0.999999)
    if solver in (Solver.NEWTON, Solver.BISECTION):
        t = _safeguarded_newton(rg, tgt, t_lo, t_hi, iters,
                                use_newton=solver == Solver.NEWTON)
    elif solver in (Solver.ANALYTIC_NEWTON, Solver.ANALYTIC_BISECTION):
        t = _safeguarded_newton(rg, tgt, t_lo, t_hi, iters,
                                use_newton=solver == Solver.ANALYTIC_NEWTON)
        if finisher:
            t = _analytic_finisher(rg, tgt, t)
        t_ana, ok = _analytic_single(rg, tgt)
        t = torch.where((gsum(rg.hit.to(torch.int32)) == 1) & ok, t_ana, t)
    elif solver == Solver.UNIFORM:
        if u_uniform is None:
            raise ValueError("the UNIFORM solver needs u_uniform")
        t = _uniform_in_segment(rg, tgt, u_uniform, iters)
    else:
        raise ValueError(f"unknown solver {solver}")
    return torch.where(scattered, t, NO_SCATTER), scattered


# -----------------------------------------------------------------------------
# Differentiable free-flight sampling (implicit function theorem,
# gvr_tpu/ops/solvers.py:273-311).  The root t(theta) of tau(t; theta) =
# target has dt/dtheta = -(d tau / d theta at fixed t) / sigma_t(t) and
# dt/dtarget = 1 / sigma_t(t), so gradients of the sampled scatter point
# reach the Gaussian parameters without the solver's iterations on the
# tape.
# -----------------------------------------------------------------------------

class _ConditionalFreeFlight(torch.autograd.Function):
    """apply(target, *rg): RayGaussians is passed field by field, so that
    autograd sees each tensor; the boolean ``hit`` gets no gradient."""

    @staticmethod
    def forward(ctx, target, *fields):
        rg = RayGaussians(*fields)
        t_lo, t_hi, tau_max = _bracket(rg)
        tgt = torch.minimum(target, tau_max * 0.999999)
        t = _safeguarded_newton(rg, tgt, t_lo, t_hi, 24, use_newton=True)
        ctx.save_for_backward(t, *fields)
        return t

    @staticmethod
    def backward(ctx, g):
        t, *fields = ctx.saved_tensors
        want = ctx.needs_input_grad[1:]
        with torch.enable_grad():
            leaves = [f.detach().requires_grad_(w and f.is_floating_point())
                      for f, w in zip(fields, want)]
            rg = RayGaussians(*leaves)
            with torch.no_grad():
                sigma = torch.clamp(sigma_t_at(rg, t), min=1e-12)
            wrt = [x for x in leaves if x.requires_grad]
            grads = iter(torch.autograd.grad(
                tau_up_to(rg, t), wrt, grad_outputs=-g / sigma,
                allow_unused=True) if wrt else ())
        return (g / sigma,) + tuple(next(grads) if x.requires_grad else None
                                    for x in leaves)


def solve_conditional_free_flight(rg: RayGaussians, target):
    """The free-flight distance [...] for targets already conditioned to
    scatter (target < the ray's total optical depth): 24 safeguarded
    Newton steps without a graph, differentiable in rg's float fields and
    in target by the implicit-function VJP (``_ConditionalFreeFlight``).
    """
    return _ConditionalFreeFlight.apply(target, *rg)
