"""Closed-form Gaussian optical depth and transmittance along rays.

Counterpart of ``gvr_tpu/ops/transmittance.py:38-228`` (reference
``gaussian.h:208-231``, ``gmm.h:145-226``).  The optical depth of one
Gaussian over [u, v] along a ray is

    tau(u, v) = pref * (erf(F(v)) - erf(F(u))),
    pref = density * norm * exp(-m2 / 2) * sqrt(pi / (2A)),
    F(t) = (B + 2 A t) / (2 sqrt(2 A)),

with m2 the squared Mahalanobis distance at the ray's closest approach.
The optical depth of the mixture up to t is the sum of each hit
Gaussian's over its clipped interval [max(t0, 0), min(t1, t)]: dense
[rays, N] elementwise work, reduced over the Gaussian axis through
``ops/gaxis``.  This is plain PyTorch, as the JAX package's is plain XLA.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from gvr_tpu_torch.ops import gaxis
from gvr_tpu_torch.ops.gaxis import gany, gmax, gshared, gsum
from gvr_tpu_torch.ops.quadratics import ray_quadratics_ab, sym6_terms
from gvr_tpu_torch.scene.gaussians import R_CUT, GaussianMixture


class RayGaussians(NamedTuple):
    """Per-(ray, Gaussian) quantities, each [..., N].

    peak = density * norm * exp(-m2/2), the extinction at the ray's closest
    approach; pref = peak * sqrt(pi / (2A)); fscale = 1 / (2 sqrt(2A));
    the interval [t0, t1] (t0 clamped to 0) and the hit mask; erf_lo and
    erf_hi, erf(F) at the interval's ends; tau_i = pref * (erf_hi -
    erf_lo), the Gaussian's whole optical depth along the ray."""

    a: torch.Tensor
    b: torch.Tensor
    peak: torch.Tensor
    pref: torch.Tensor
    fscale: torch.Tensor
    t0: torch.Tensor
    t1: torch.Tensor
    hit: torch.Tensor
    erf_lo: torch.Tensor
    erf_hi: torch.Tensor
    tau_i: torch.Tensor


def _rdiv(c: float, x: torch.Tensor) -> torch.Tensor:
    """c / x rounded once, as XLA divides (torch's ``c / x`` is
    ``x.reciprocal() * c``, rounded twice)."""
    return torch.full_like(x, c) / x


def _as_t(t, like: torch.Tensor) -> torch.Tensor:
    """t (a number or a tensor [...]) as float32 broadcastable against
    ``like`` [..., N]."""
    t = gshared(torch.as_tensor(t, dtype=torch.float32, device=like.device))
    return t[..., None] if t.dim() < like.dim() else t


def min_mahalanobis_sq(gmm: GaussianMixture, origin, direction, a, b):
    """(m2, t*): the squared Mahalanobis distance at the ray's closest
    approach x* = o + t* d, t* = -b / (2a), evaluated as the positive
    quadratic form at x* (no cancellation of C - B^2 / 4A)."""
    t_star = -b / (2.0 * torch.clamp(a, min=1e-30))
    # x* - mean by components, [..., N] each
    v = [(origin[..., None, i] - gmm.mean[:, i])
         + t_star * direction[..., None, i] for i in range(3)]
    feats = sym6_terms(v, v)
    ic = gmm.icpack()
    m2 = feats[0] * ic[:, 0]
    for f in range(1, 6):
        m2 = m2 + feats[f] * ic[:, f]
    return torch.clamp(m2, min=0.0), t_star


def _interval_pref(gmm: GaussianMixture, origin, direction):
    """(a, b, t0, t1, hit, peak, pref, fscale): the clipped support
    interval t* -/+ sqrt((R^2 - m2) / a) and the erf prefactors of each
    (ray, Gaussian) pair, shared by tau_coeffs and transmittance_up_to."""
    origin, direction = gshared(origin), gshared(direction)
    a, b = ray_quadratics_ab(gmm, origin, direction)
    a_safe = torch.clamp(a, min=1e-30)
    m2, t_star = min_mahalanobis_sq(gmm, origin, direction, a, b)
    gap = (R_CUT * R_CUT - m2) / a_safe
    half = torch.sqrt(torch.where(gap > 0.0, gap, 0.0))
    t1 = t_star + half
    t0 = torch.clamp(t_star - half, min=0.0)
    hit = (gap > 0.0) & (t1 >= 0.0)
    peak = gmm.density * gmm.norm * torch.exp(-0.5 * m2)
    pref = peak * torch.sqrt(_rdiv(math.pi, 2.0 * a_safe))
    fscale = 1.0 / (2.0 * torch.sqrt(2.0 * a_safe))
    return a, b, t0, t1, hit, peak, pref, fscale


def tau_coeffs(gmm: GaussianMixture, origin, direction) -> RayGaussians:
    """Everything the optical depth along rays [..., 3] needs."""
    a, b, t0, t1, hit, peak, pref, fscale = _interval_pref(
        gmm, origin, direction)
    erf_lo = torch.erf((b + 2.0 * a * t0) * fscale)
    erf_hi = torch.erf((b + 2.0 * a * t1) * fscale)
    tau_i = torch.where(hit, pref * (erf_hi - erf_lo), 0.0)
    return RayGaussians(a, b, peak, pref, fscale, t0, t1, hit, erf_lo,
                        erf_hi, tau_i)


def _ferf(rg: RayGaussians, t):
    """erf(F(t)), F(t) = (B + 2 A t) * fscale."""
    return torch.erf((rg.b + 2.0 * rg.a * t) * rg.fscale)


def tau_interval(rg: RayGaussians, u, v):
    """Each Gaussian's optical depth over the raw interval [u, v]
    (``Gaussian::optical_depth``)."""
    return rg.pref * (_ferf(rg, v) - _ferf(rg, u))


def tau_up_to(rg: RayGaussians, t):
    """The mixture's optical depth from 0 to t (a number or [...]): over
    the hit Gaussians, tau over [t0, min(t1, t)], one erf a pair."""
    tt = _as_t(t, rg.t1)
    seg = torch.where(tt >= rg.t1, rg.tau_i,
                      rg.pref * (_ferf(rg, tt) - rg.erf_lo))
    return gsum(torch.where(rg.hit & (tt > rg.t0), seg, 0.0))


def tau_total(rg: RayGaussians):
    """Optical depth through the whole medium, from the per-Gaussian
    totals."""
    return gsum(torch.where(rg.hit, rg.tau_i, 0.0))


def extinction_at(rg: RayGaussians, t):
    """(rho, inside): each Gaussian's extinction along the ray at t,
    peak * exp(-(sqrt(A) t + B / (2 sqrt(A)))^2 / 2), and whether t lies
    in its interval."""
    tt = _as_t(t, rg.t1)
    sa = torch.sqrt(torch.clamp(rg.a, min=1e-30))
    z = sa * tt + rg.b / (2.0 * sa)
    rho = rg.peak * torch.exp(-0.5 * z * z)
    return rho, rg.hit & (tt >= rg.t0) & (tt <= rg.t1)


def sigma_t_at(rg: RayGaussians, t):
    """d tau_up_to / dt at t: the summed extinction of the Gaussians whose
    interval holds t."""
    rho, inside = extinction_at(rg, t)
    return gsum(torch.where(inside, rho, 0.0))


def transmittance_up_to(gmm: GaussianMixture, origin, direction, tmax):
    """T = exp(-tau(tmax)) along rays [..., 3] (gmm.h:207-226, 517-578), in
    one pass of two erfs a pair: the NEE shadow and environment rays."""
    a, b, lo, t1, hit, _, pref, fscale = _interval_pref(
        gmm, origin, direction)
    hi = torch.minimum(t1, _as_t(tmax, t1))
    seg = pref * (torch.erf((b + 2.0 * a * hi) * fscale)
                  - torch.erf((b + 2.0 * a * lo) * fscale))
    return torch.exp(-gsum(torch.where(hit & (hi > lo), seg, 0.0)))


def transmittance_over_segment(rg: RayGaussians, u, v, active_mask):
    """T over [u, v] restricted to an explicit active mask [..., N]
    (gmm.h:145-157), the analytic ray marcher's step."""
    seg = tau_interval(rg, _as_t(u, rg.t1), _as_t(v, rg.t1))
    return torch.exp(-gsum(torch.where(active_mask, seg, 0.0)))


def compact_candidates(rg: RayGaussians, albedo, k: int):
    """(rg_k, albedo_k [..., k], overflow [...]): the k hit Gaussians of
    each ray that it enters first, the replacement of BVH candidate
    pruning (gmm.h:457-515).  Exact where a ray hits at most k Gaussians
    (``overflow`` flags the others).  Misses rank last; the order of ties
    (the padding of a ray with fewer than k hits) is torch.topk's, not
    lax.top_k's, which changes no optical depth, root or albedo."""
    if gaxis.active() is not None:
        raise ValueError("candidate compaction (top-k over the Gaussian "
                         "axis) is not tensor-parallel; use candidate_k=0")
    key = torch.where(rg.hit, -rg.t0, -torch.inf)
    idx = torch.topk(key, k, dim=-1).indices
    rg_k = RayGaussians(*(torch.gather(f, -1, idx) for f in rg))
    overflow = rg.hit.sum(dim=-1) > k
    return rg_k, albedo[idx], overflow


def albedo_at_from_rg(rg: RayGaussians, albedo, t):
    """The mixture's albedo at t from the (compacted) ray-Gaussian state
    (gmm.h:128-143): the extinction-weighted mean of the albedos of the
    Gaussians whose interval holds t, clamped to [0, 1]."""
    rho, inside = extinction_at(rg, t)
    w = torch.where(inside, rho, 0.0)
    s = gsum(w)
    sa = gsum(w * albedo)
    s_safe = torch.where(s > 1e-25, s, 1.0)
    return torch.clamp(torch.where(s > 1e-25, sa / s_safe, 0.0), 0.0, 1.0)


def far_bound(rg: RayGaussians):
    """The farthest exit over the hit Gaussians (0 if none): the end of the
    medium along the ray."""
    return gmax(torch.where(rg.hit, rg.t1, 0.0))


def any_hit(rg: RayGaussians):
    return gany(rg.hit)
