"""The port's ops/quadratics, ops/transmittance, ops/solvers and the
mixture's pointwise functions on the CPU against the JAX package's, on the
same inputs (numpy from a seed), each at the tolerance its test states;
then the port's own versions of the JAX package's solver property tests
(tests/test_solvers.py:18-82)."""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_common  # noqa: F401  (sets torch threads)
from _torch_common import port_scene, random_rays
from gvr_tpu.cameras import pixel_center_uv as jax_pixel_center_uv
from gvr_tpu.config import Solver as JSolver
from gvr_tpu.ops import quadratics as jq
from gvr_tpu.ops import solvers as js
from gvr_tpu.ops import transmittance as jt
from gvr_tpu.scene.generators import random_gaussian_scene
from gvr_tpu.scene.scene import parse_gmm as jax_parse_gmm
from gvr_tpu.utils import image as jimage
from gvr_tpu_torch.cameras import pixel_center_uv
from gvr_tpu_torch.config import Solver
from gvr_tpu_torch.ops import gaxis
from gvr_tpu_torch.ops import quadratics as tq
from gvr_tpu_torch.ops import solvers as ts
from gvr_tpu_torch.ops import transmittance as tt
from gvr_tpu_torch.scene.convert import ray_gaussians_from_numpy
from gvr_tpu_torch.scene.gaussians import GaussianMixture
from gvr_tpu_torch.utils import image as timage
from oracle import OracleMixture

SCENES = {
    "24": random_gaussian_scene(24, seed=7, diameter=(0.2, 0.6),
                                density=(0.5, 2.0)),
    "250": random_gaussian_scene(250, seed=0),
}
RAYS = 2048


@pytest.fixture(scope="module", params=sorted(SCENES))
def pair(request):
    """(JAX scene, port scene, o, d, xi) on RAYS rays: half from around
    the scenes' box (tests/_torch_common.random_rays), half from far away
    aimed into it."""
    jsc = jax_parse_gmm(SCENES[request.param])
    o, d, xi = random_rays(RAYS, seed=11)
    r = np.random.default_rng(12)
    far = r.uniform(-4, 4, (RAYS // 2, 3)) + [0.0, 1.0, 0.0]
    aim = r.uniform(-0.8, 0.8, (RAYS // 2, 3)) + [0.0, 1.0, 0.0]
    fd = aim - far
    o[RAYS // 2:] = far
    d[RAYS // 2:] = fd / np.linalg.norm(fd, axis=-1, keepdims=True)
    return jsc, port_scene(jsc), o, d, xi


def _j(x):
    return jnp.asarray(x)


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _close(got, want, rtol, atol, mask=None, extra=0.0, share=1.0):
    """|got - want| <= atol + rtol |want| + extra (where mask) on at least
    ``share`` of the elements and within 10 times that everywhere; extra
    is the float32 resolution of a sum whose terms cancel (an array or
    0).  A share below 1 admits the few ill-conditioned elements (near
    tangent rays, whose B cancels to a few ulps of its terms) where two
    float32 implementations part further."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    extra = np.broadcast_to(np.asarray(extra, np.float64), want.shape)
    if mask is not None:
        got, want, extra = got[mask], want[mask], extra[mask]
    err = np.abs(got.astype(np.float64) - want)
    bar = atol + rtol * np.abs(want) + extra
    bad = err > bar
    assert bad.mean() <= 1.0 - share and not (err > 10.0 * bar).any(), (
        f"{bad.sum()} of {bad.size} beyond the bar: got {got[bad][:5]}, "
        f"want {want[bad][:5]}")


# The float32 resolution of a sum or difference: 2^-22 (two ulps at 1)
# times the sum of the magnitudes of its terms.
RES = 2.0 ** -22


def _erf_res(rg) -> np.ndarray:
    """[rays, 1]: the resolution of a ray's erf differences, RES times the
    sum of its hit Gaussians' pref (erf values lie in [-1, 1])."""
    return RES * tt.gsum(torch.where(rg.hit, rg.pref, 0.0))[:, None].numpy()


def _term_scales(gmm, o, d):
    """The sums of the magnitudes of the terms of B and C: B = 2 (od.ic -
    d.q) and C = oo.ic - 2 o.q + c0 cancel terms of up to ~1e5."""
    ic, q = gmm.icpack().abs(), gmm.qvec().abs()
    o, d = _t(o).abs(), _t(d).abs()
    sb = 2.0 * (tq._mm(tq.sym6(o, d), ic) + tq._mm(d, q))
    sc = tq._mm(tq.sym6(o, o), ic) + 2.0 * tq._mm(o, q) + gmm.c0().abs()
    return sb.numpy(), sc.numpy()


def test_quadratics_match_jax(pair):
    """a, b and c at rtol 1e-5 / atol 1e-5 on 99.9 % of the pairs, b and c
    also within the float32 resolution of their cancelling terms (RES
    times the sum of their magnitudes); the hit masks equal; t0 and t1
    where the ray hits at rtol 1e-5 / atol 1e-5 plus the resolution that
    b, c and the discriminant b^2 - 4a(c - 9), which cancels terms of up
    to ~1e10, carry into them."""
    jsc, sc, o, d, _ = pair
    ja, jb, jc = jq.ray_quadratics(jsc.medium, _j(o), _j(d))
    a, b, c = tq.ray_quadratics(sc.medium, _t(o), _t(d))
    sb, sc_ = _term_scales(sc.medium, o, d)
    _close(a, ja, 1e-5, 1e-5, share=0.999)
    _close(b, jb, 1e-5, 1e-5, extra=RES * sb, share=0.999)
    _close(c, jc, 1e-5, 1e-5, extra=RES * sc_, share=0.999)
    jt0, jt1, jhit = jq.intersect_gaussians(jsc.medium, _j(o), _j(d))
    t0, t1, hit = tq.intersect_gaussians(sc.medium, _t(o), _t(d))
    assert np.array_equal(hit.numpy(), np.asarray(jhit))
    assert hit.any()
    an, bn, cn = a.numpy().astype(np.float64), b.numpy(), c.numpy()
    db, dc = RES * sb, RES * sc_
    cc = cn - 9.0
    ddisc = (2.0 * np.abs(bn) * db + 4.0 * an * dc
             + RES * (bn * bn + 4.0 * an * np.abs(cc)))
    sq = np.sqrt(np.maximum(bn * bn - 4.0 * an * cc, 0.0))
    dt = (db + ddisc / np.maximum(2.0 * sq, 1e-30)) / np.maximum(2.0 * an,
                                                                  1e-30)
    _close(t0, jt0, 1e-5, 1e-5, hit.numpy(), dt)
    _close(t1, jt1, 1e-5, 1e-5, hit.numpy(), dt)


def test_whitening_matches_direct(pair):
    """The whitening variant against the direct quadratic, as
    tests/test_raymarch_extra.py:22-36 holds the JAX package's: hits
    agree on 98 % of the pairs, t0 and t1 at rtol / atol 5e-3."""
    _, sc, o, d, _ = pair
    t0a, t1a, ha = tq.intersect_gaussians(sc.medium, _t(o), _t(d))
    t0b, t1b, hb = tq.intersect_gaussians_whitening(sc.medium, _t(o), _t(d))
    both = (ha & hb).numpy()
    assert (ha == hb).float().mean() > 0.98
    _close(t0a, t0b, 5e-3, 5e-3, both)
    _close(t1a, t1b, 5e-3, 5e-3, both)


def _rg_pair(pair):
    jsc, sc, o, d, xi = pair
    return (jt.tau_coeffs(jsc.medium, _j(o), _j(d)),
            tt.tau_coeffs(sc.medium, _t(o), _t(d)), xi)


TAU_FNS = ["tau_coeffs", "min_mahalanobis_sq", "tau_interval", "tau_up_to",
           "tau_total", "sigma_t_at", "extinction_at",
           "transmittance_up_to", "transmittance_over_segment",
           "albedo_at_from_rg", "far_bound", "any_hit"]


@pytest.mark.parametrize("fn", TAU_FNS)
def test_transmittance_matches_jax(pair, fn):
    """Each function of ops/transmittance at rtol 1e-4 / atol 1e-6 on
    99.9 % of the elements, at distances t from a seed over [0, 1.2 x the
    ray's far bound]; B (a field of tau_coeffs) also within the
    resolution of its terms, and an optical depth or transmittance also
    within that of its erf differences (``_erf_res``, times T for a
    transmittance).  erf_lo and erf_hi are held where the ray hits the
    Gaussian (elsewhere their arguments are the cancelled B of a miss)."""
    jsc, sc, o, d, xi = pair
    jrg, rg, _ = _rg_pair(pair)
    far = np.asarray(jt.far_bound(jrg))
    t = (xi[:, 0] * 1.2 * far).astype(np.float32)
    u = (xi[:, 1] * far).astype(np.float32)
    v = (u + xi[:, 2] * 0.5).astype(np.float32)
    act_j = jrg.hit & (jrg.t0 <= _j(u)[:, None])
    act_t = rg.hit & (rg.t0 <= _t(u)[:, None])
    calls = {
        "tau_coeffs": (lambda m: jrg, lambda m: rg),
        "min_mahalanobis_sq": (
            lambda m: jt.min_mahalanobis_sq(jsc.medium, _j(o), _j(d),
                                            jrg.a, jrg.b),
            lambda m: tt.min_mahalanobis_sq(sc.medium, _t(o), _t(d), rg.a,
                                            rg.b)),
        "tau_interval": (
            lambda m: jt.tau_interval(jrg, _j(u)[:, None], _j(v)[:, None]),
            lambda m: tt.tau_interval(rg, _t(u)[:, None], _t(v)[:, None])),
        "tau_up_to": (lambda m: m.tau_up_to(jrg, _j(t)),
                      lambda m: m.tau_up_to(rg, _t(t))),
        "tau_total": (lambda m: m.tau_total(jrg), lambda m: m.tau_total(rg)),
        "sigma_t_at": (lambda m: m.sigma_t_at(jrg, _j(t)),
                       lambda m: m.sigma_t_at(rg, _t(t))),
        "extinction_at": (lambda m: m.extinction_at(jrg, _j(t)),
                          lambda m: m.extinction_at(rg, _t(t))),
        "transmittance_up_to": (
            lambda m: jt.transmittance_up_to(jsc.medium, _j(o), _j(d),
                                             _j(t)),
            lambda m: tt.transmittance_up_to(sc.medium, _t(o), _t(d),
                                             _t(t))),
        "transmittance_over_segment": (
            lambda m: jt.transmittance_over_segment(jrg, _j(u), _j(v),
                                                    act_j),
            lambda m: tt.transmittance_over_segment(rg, _t(u), _t(v),
                                                    act_t)),
        "albedo_at_from_rg": (
            lambda m: jt.albedo_at_from_rg(jrg, jsc.medium.albedo, _j(t)),
            lambda m: tt.albedo_at_from_rg(rg, sc.medium.albedo, _t(t))),
        "far_bound": (lambda m: m.far_bound(jrg), lambda m: m.far_bound(rg)),
        "any_hit": (lambda m: m.any_hit(jrg), lambda m: m.any_hit(rg)),
    }
    want, got = calls[fn][0](jt), calls[fn][1](tt)
    res = _erf_res(rg)
    if fn == "tau_coeffs":
        extra = {"b": RES * _term_scales(sc.medium, o, d)[0], "tau_i": res}
        extra = [extra.get(k, 0.0) for k in rg._fields]
    elif fn in ("tau_interval", "tau_up_to", "tau_total"):
        extra = [res if fn == "tau_interval" else res[:, 0]]
    elif fn == "transmittance_up_to":
        extra = [res[:, 0] * got.numpy()]
    elif fn == "transmittance_over_segment":
        extra = [res[:, 0] * got.numpy()]
    else:
        extra = [0.0, 0.0]
    if not isinstance(want, tuple):
        want, got = (want,), (got,)
    mask = [rg.hit.numpy() if k in ("erf_lo", "erf_hi") else None
            for k in rg._fields] if fn == "tau_coeffs" else [None, None]
    for w, g, x, m in zip(want, got, extra, mask):
        w = np.asarray(w)
        g = g.numpy()
        if w.dtype == bool:
            assert np.array_equal(g, w)
        else:
            _close(g, w, 1e-4, 1e-6, m, x, share=0.999)


SOLVERS = ["newton", "bisection", "analytic_newton", "analytic_bisection",
           "uniform"]


def _halved_bracket(rg, solver: str, iters: int) -> np.ndarray:
    """A bisecting solver's bracket after ``iters`` halvings, (t_hi - t_lo)
    2^-iters: where a step's sign test sits within rounding of the root,
    the two packages halve toward different sides, and their results
    part by up to this.  0 for the Newton solvers."""
    if "bisection" not in solver:
        return np.zeros(rg.t0.shape[0])
    t_lo, t_hi, _ = ts._bracket(rg)
    return ((t_hi - t_lo) * 2.0 ** -iters).numpy()


@pytest.mark.parametrize("finisher", [False, True])
@pytest.mark.parametrize("solver", SOLVERS)
def test_sample_free_flight_matches_jax(pair, solver, finisher):
    """Both packages' solvers on the JAX package's RayGaussians, carried
    across: scatter decisions equal on >= 99.9 % of the rays, t within
    1e-4 relative (plus 1e-6, plus for the bisecting solvers the bracket
    left after their halvings) where both scatter.  torch.erfinv and
    XLA's erf_inv are different approximations, so the analytic solvers
    are held to this tolerance in t, not to bits."""
    jrg, _, xi = _rg_pair(pair)
    rg = ray_gaussians_from_numpy({k: np.asarray(v)
                                   for k, v in jrg._asdict().items()})
    target = -np.log(np.maximum(1.0 - xi[:, 0], 1e-12)).astype(np.float32)
    u = xi[:, 8]
    jt_sc, js_ = js.sample_free_flight(
        jrg, _j(target), JSolver(solver), 12, _j(u), finisher=finisher)
    t_sc, s_ = ts.sample_free_flight(rg, _t(target), Solver(solver), 12,
                                     _t(u), finisher=finisher)
    js_, s_ = np.asarray(js_), s_.numpy()
    assert (js_ == s_).mean() >= 0.999 and s_.sum() > RAYS // 8
    both = js_ & s_
    _close(t_sc, jt_sc, 1e-4, 1e-6, both, _halved_bracket(rg, solver, 12))
    assert np.all(t_sc.numpy()[~s_] == ts.NO_SCATTER)


@pytest.mark.parametrize("k", [4, 8])
def test_compact_candidates_match_jax(pair, k):
    """compact_candidates by what it computes: the compacted state's total
    and partial optical depth, extinction, albedo and free-flight root
    (bars as test_transmittance_matches_jax's and
    test_sample_free_flight_matches_jax's, on 99.9 % of the rays), and
    the overflow flags.  The order of ties differs between lax.top_k and
    torch.topk, so indices are not compared, and a ray that overflows
    with a tie at the cut (its
    k-th and k+1-th entries within 1e-5 relative, as where its origin
    lies inside more than k Gaussians, t0 = 0, or where two entries part
    by the packages' rounding) may keep other Gaussians: those rays, at
    most 1 %, are left out."""
    jsc, sc, _, _, xi = pair
    jrg, rg, _ = _rg_pair(pair)
    jk, jalb, jover = jt.compact_candidates(jrg, jsc.medium.albedo, k)
    rk, alb, over = tt.compact_candidates(rg, sc.medium.albedo, k)
    assert rk.t0.shape == (RAYS, k) and alb.shape == (RAYS, k)
    assert np.array_equal(over.numpy(), np.asarray(jover))
    keys = torch.sort(torch.where(rg.hit, rg.t0, torch.inf), dim=-1).values
    tie = (keys[:, k] - keys[:, k - 1]) <= 1e-5 * keys[:, k].abs()
    keep = (~(over & tie)).numpy()
    assert keep.mean() >= 0.99
    far = np.asarray(jt.far_bound(jk))
    t = (xi[:, 0] * far).astype(np.float32)
    res = _erf_res(rk)[:, 0]
    _close(tt.tau_total(rk), jt.tau_total(jk), 1e-4, 1e-6, keep, res, 0.999)
    _close(tt.tau_up_to(rk, _t(t)), jt.tau_up_to(jk, _j(t)), 1e-4, 1e-6,
           keep, res, 0.999)
    _close(tt.sigma_t_at(rk, _t(t)), jt.sigma_t_at(jk, _j(t)), 1e-4, 1e-6,
           keep, share=0.999)
    _close(tt.albedo_at_from_rg(rk, alb, _t(t)),
           jt.albedo_at_from_rg(jk, jalb, _j(t)), 1e-4, 1e-6, keep,
           share=0.999)
    target = (-np.log(1.0 - xi[:, 1])).astype(np.float32)
    jt_sc, js_ = js.sample_free_flight(jk, _j(target), JSolver.BISECTION, 12)
    t_sc, s_ = ts.sample_free_flight(rk, _t(target), Solver.BISECTION, 12)
    s_, js_ = s_.numpy(), np.asarray(js_)
    assert (s_ == js_)[keep].mean() >= 0.999
    _close(t_sc, jt_sc, 1e-4, 1e-6, keep & s_ & js_,
           _halved_bracket(rk, "bisection", 12), 0.999)


@pytest.mark.parametrize("fn", ["evaluate", "mu_t", "sigma_albedo",
                                "albedo_at"])
def test_mixture_at_points_matches_jax(pair, fn):
    """GaussianMixture.evaluate / mu_t / sigma_albedo / albedo_at at points
    from a seed, over a random active mask: rtol 1e-4 / atol 1e-6."""
    jsc, sc, o, _, xi = pair
    x = o[:256]
    mask = xi[:256, :1] < (np.arange(sc.medium.n) % 7 + 1) / 7.0
    args_j = (_j(x),) if fn in ("evaluate", "mu_t") else (_j(x), _j(mask))
    args_t = (_t(x),) if fn in ("evaluate", "mu_t") else (_t(x), _t(mask))
    want = getattr(jsc.medium, fn)(*args_j)
    got = getattr(sc.medium, fn)(*args_t)
    if not isinstance(want, tuple):
        want, got = (want,), (got,)
    for w, g in zip(want, got):
        _close(g, w, 1e-4, 1e-6)


def test_pixel_center_uv_and_image_metrics_match_jax():
    assert np.array_equal(pixel_center_uv(7, 5).numpy(),
                          np.asarray(jax_pixel_center_uv(7, 5)))
    r = np.random.default_rng(3)
    a, b = r.uniform(size=(2, 8, 8, 3))
    assert timage.mse(a, b) == jimage.mse(a, b)
    assert timage.psnr(a, b) == jimage.psnr(a, b)
    assert timage.psnr(a, a) == math.inf


def test_gaxis_reductions():
    x = torch.tensor([[1.0, -2.0, 3.0], [0.0, 0.0, 0.0]])
    assert gaxis.gsum(x).tolist() == [2.0, 0.0]
    assert gaxis.gmax(x).tolist() == [3.0, 0.0]
    assert gaxis.gmin(x).tolist() == [-2.0, 0.0]
    assert gaxis.gany(x != 0).tolist() == [True, False]
    assert gaxis.active() is None


# ---- the JAX package's solver property tests, on the port -------------

def _oracle_pair(seed: int, n: int):
    """A port mixture of n random Gaussians (tests/oracle.py) and 128
    rays aimed into it (tests/test_gaussian_math.py:random_rays)."""
    rng = np.random.default_rng(seed)
    om = OracleMixture.random(rng, n)
    gm = GaussianMixture.from_covariances(
        np.array([g.mean for g in om.g]), np.array([g.cov for g in om.g]),
        np.array([g.density for g in om.g]),
        np.array([g.albedo for g in om.g]))
    o = rng.uniform(-4, 4, (128, 3))
    d = rng.uniform(-0.8, 0.8, (128, 3)) - o
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    rg = tt.tau_coeffs(gm, _t(o.astype(np.float32)),
                       _t(d.astype(np.float32)))
    return rg, tt.tau_up_to(rg, tt.far_bound(rg)), rng


@pytest.mark.parametrize("solver", ["newton", "bisection", "analytic_newton",
                                    "analytic_bisection"])
def test_solver_inverts_tau(solver):
    rg, tau_max, _ = _oracle_pair(1, 6)
    target = 0.5 * tau_max + 1e-9
    t, scattered = ts.sample_free_flight(rg, target, Solver(solver),
                                         iters=40)
    assert scattered.sum() > 16
    tau_at = tt.tau_up_to(rg, torch.where(scattered, t, 0.0))
    good = scattered & (tau_max > 1e-4)
    _close(tau_at, target, 2e-3, 2e-4, good.numpy())


def test_no_scatter_past_tau_max():
    rg, tau_max, _ = _oracle_pair(2, 4)
    t, scattered = ts.sample_free_flight(rg, tau_max * 1.5 + 1.0,
                                         Solver.NEWTON, iters=24)
    assert not scattered.any()
    assert torch.all(t == ts.NO_SCATTER)


def test_analytic_matches_newton_single_gaussian():
    rg, tau_max, _ = _oracle_pair(3, 1)
    target = 0.7 * tau_max + 1e-9
    t_n, s_n = ts.sample_free_flight(rg, target, Solver.NEWTON, iters=40)
    t_a, _ = ts.sample_free_flight(rg, target, Solver.ANALYTIC_NEWTON,
                                   iters=40)
    good = (s_n & (tau_max > 1e-4)).numpy()
    assert good.sum() > 8
    _close(t_a, t_n, 1e-3, 1e-3, good)


def test_uniform_stays_in_its_segment():
    """UNIFORM returns a t between the nearest interval ends around the
    root (distance_solvers.h:132-137), inside [first entry, far bound]."""
    rg, tau_max, rng = _oracle_pair(4, 4)
    target = 0.5 * tau_max + 1e-9
    u = torch.from_numpy(rng.uniform(size=128).astype(np.float32))
    t, scattered = ts.sample_free_flight(rg, target, Solver.UNIFORM, iters=1,
                                         u_uniform=u)
    good = scattered & (tau_max > 1e-3)
    assert good.sum() > 16
    t_lo = torch.where(rg.hit, rg.t0, torch.inf).amin(dim=-1)
    t_hi = tt.far_bound(rg)
    assert torch.all(t[good] >= t_lo[good] - 1e-5)
    assert torch.all(t[good] <= t_hi[good] + 1e-5)
    # and within the event segment of its own root at iters=1
    ts_ = ts._safeguarded_newton(rg, target, *ts._bracket(rg)[:2], 1)
    ev = torch.cat([torch.where(rg.hit, rg.t0, torch.nan),
                    torch.where(rg.hit, rg.t1, torch.nan)], dim=-1)
    lo = torch.where(ev <= ts_[:, None], ev, -torch.inf).nan_to_num(
        nan=-torch.inf).amax(dim=-1)
    hi = torch.where(ev > ts_[:, None], ev, torch.inf).nan_to_num(
        nan=torch.inf).amin(dim=-1)
    inside = (t >= torch.maximum(lo, t_lo) - 1e-5) & (t <= hi + 1e-5)
    assert torch.all(inside[good])
