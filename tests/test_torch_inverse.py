"""The port's inverse renderer on the CPU against the JAX package's: the
11-parameter codec, the conditional free-flight solve and its
implicit-function VJP, the differentiable estimator, fit_loss and its
gradients, the Adam update, checkpoints in both directions, attribution
and SFD, each on the same inputs; then the port's own versions of the
JAX package's inverse tests (tests/test_inverse.py) and `cli fit`.

Where losses, gradients or Adam steps are compared, both packages get the
JAX package's packed vector: eigh's eigenvector signs (and its basis where
eigenvalues repeat) differ between the packages, so two packed vectors of
one parsed scene may differ while they decode to the same covariances."""

import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import _torch_common  # noqa: F401  (sets torch threads)
from _torch_common import port_camera, port_scene, random_rays
from gvr_tpu.cameras import PinholeCamera as JPinhole
from gvr_tpu.config import FitConfig as JFitConfig
from gvr_tpu.config import RenderConfig as JConfig
from gvr_tpu.integrators.multiscatter import \
    multiscatter_radiance_diff as jax_diff
from gvr_tpu.inverse import attribution as jattr
from gvr_tpu.inverse import fit as jfit
from gvr_tpu.inverse import sfd as jsfd
from gvr_tpu.ops import solvers as jsolvers
from gvr_tpu.ops import transmittance as jtrans
from gvr_tpu.parallel.sharding import make_mesh
from gvr_tpu.scene import gaussians as jg
from gvr_tpu.scene.generators import random_gaussian_scene
from gvr_tpu.scene.scene import parse_gmm as jax_parse_gmm
from gvr_tpu_torch import cli
from gvr_tpu_torch.config import FitConfig, RenderConfig
from gvr_tpu_torch.integrators.multiscatter import (
    multiscatter_radiance_diff, render_multiscatter)
from gvr_tpu_torch.inverse import attribution as tattr
from gvr_tpu_torch.inverse import fit as tfit
from gvr_tpu_torch.inverse import sfd as tsfd
from gvr_tpu_torch.io.ppm import read_ppm, write_ppm
from gvr_tpu_torch.ops.solvers import solve_conditional_free_flight
from gvr_tpu_torch.ops.transmittance import RayGaussians
from gvr_tpu_torch.scene import gaussians as tg
from gvr_tpu_torch.scene.convert import (params_from_numpy,
                                         ray_gaussians_from_numpy)
from gvr_tpu_torch.scene.scene import parse_gmm
from gvr_tpu_torch.testing import (FIT_BARS, fit_agreement,
                                   image_agreement, scene_text)
from gvr_tpu_torch.utils.image import psnr

# tests/test_inverse.py's two-Gaussian scene and camera, and its
# 10-Gaussian scene
SCENE = ("l 0 4 0  8 8 8\n"
         "g 0.1 1.0 0.2  0.08 0.01 0  0.07 0 0.09  1.5 0.7\n"
         "g -0.2 0.8 -0.1  0.05 0 0.01  0.06 0 0.08  1.0 0.4\n")
SCENE10 = random_gaussian_scene(10, seed=2, diameter=(0.2, 0.7))
SCENES = {"two": SCENE, "ten": SCENE10}
JCAM = JPinhole.create([0, 1, 6], [0, 1, 0], 0.25 * math.pi)
CAM = port_camera(JCAM)
# the codec's float32 bars: the same vector decodes to covariances
# within 1e-6 of their scale (measured 2e-7 with the JAX package's
# einsum against the port's elementwise sums) and norms within 2e-6
CODEC_RTOL = 1e-5


@pytest.fixture(scope="module", params=sorted(SCENES))
def pair(request):
    """(name, JAX scene, port scene, JAX's packed vector as numpy)."""
    jsc = jax_parse_gmm(SCENES[request.param])
    return (request.param, jsc, port_scene(jsc),
            np.asarray(jsc.medium.pack_parameters()))


def _rays(w, h):
    """(JAX rays, port rays) through the pixel centres of a w x h image:
    (o, d, ids) each."""
    j = jfit._pixel_rays(JCAM, w, h, jnp.arange(w * h, dtype=jnp.int32))
    t = tfit._pixel_rays(CAM, w, h, torch.arange(w * h, dtype=torch.int32))
    return j, t


def _close(got, want, rtol, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= rtol * scale, f"{what}: max |diff| {err} > {rtol} * {scale}"


# ---- the codec ----------------------------------------------------------

def test_codec_decodes_like_jax(pair):
    """from_parameters of JAX's packed vector, and from_rotation_scale of
    random rotations and scales (with one collapsing scale), against the
    JAX package's, field by field."""
    _, jsc, _, jp = pair
    jm = jg.GaussianMixture.from_parameters(jnp.asarray(jp))
    tm = tg.GaussianMixture.from_parameters(params_from_numpy(jp))
    for f in ("mean", "cov", "inv_cov", "norm", "eigvals", "eigvecs",
              "density", "albedo"):
        _close(getattr(tm, f), getattr(jm, f), CODEC_RTOL, f)
    r = np.random.default_rng(3)
    rot = np.linalg.qr(r.normal(size=(8, 3, 3)))[0].astype(np.float32)
    scale = r.uniform(0.01, 0.5, (8, 3)).astype(np.float32)
    scale[0, 1] = 1e-9
    args = (r.normal(size=(8, 3)).astype(np.float32), rot, scale,
            r.uniform(0.1, 2, 8).astype(np.float32),
            r.uniform(0, 1, 8).astype(np.float32))
    jm = jg.GaussianMixture.from_rotation_scale(*args)
    tm = tg.GaussianMixture.from_rotation_scale(
        *(torch.from_numpy(a) for a in args))
    for f in ("cov", "inv_cov", "norm"):
        _close(getattr(tm, f), getattr(jm, f), CODEC_RTOL, f)
    assert torch.isfinite(tm.norm).all() and float(tm.norm[0]) > 0


def test_codec_round_trip(pair):
    """pack_parameters then from_parameters gives back the parsed
    covariances (the Rodrigues vectors may differ from JAX's: see the
    module docstring), and the port's pack decodes like JAX's."""
    _, jsc, sc, jp = pair
    tp = sc.medium.pack_parameters()
    assert tp.shape == (sc.medium.n * tg.PARAMS_PER_GAUSSIAN,)
    back = tg.GaussianMixture.from_parameters(tp)
    want = jg.GaussianMixture.from_parameters(jnp.asarray(jp))
    for f in ("cov", "inv_cov", "norm", "density", "albedo", "mean"):
        _close(getattr(back, f), getattr(want, f), CODEC_RTOL, f)
    _close(back.cov, sc.medium.cov, CODEC_RTOL, "cov vs parsed")


def _rods():
    """Rodrigues vectors [M,3]: random axes at random angles, rod = 0,
    angles 1e-5 and 1e-3, near pi (pi - 1e-4, pi - 1e-6) and at pi."""
    r = np.random.default_rng(11)
    axes = r.normal(size=(16, 3))
    axes /= np.linalg.norm(axes, axis=1, keepdims=True)
    angles = np.concatenate([r.uniform(0.01, 3.1, 10),
                             [0.0, 1e-5, 1e-3, math.pi - 1e-4,
                              math.pi - 1e-6, math.pi]])
    return (axes * angles[:, None]).astype(np.float32)


def test_rodrigues_matches_jax():
    """rodrigues_to_rotation and rotation_to_rodrigues against the JAX
    package's on the same inputs, at rod = 0 and near pi too, and the
    round trip R -> rod -> R; a non-finite rotation maps to rod = 0 in
    both."""
    rods = _rods()
    rot_j = np.asarray(jg.rodrigues_to_rotation(jnp.asarray(rods)))
    rot_t = tg.rodrigues_to_rotation(torch.from_numpy(rods))
    _close(rot_t, rot_j, 1e-6, "rotation")
    rod_j = np.asarray(jg.rotation_to_rodrigues(jnp.asarray(rot_j)))
    rod_t = tg.rotation_to_rodrigues(torch.from_numpy(rot_j)).numpy()
    _close(rod_t, rod_j, 1e-5, "rodrigues")
    _close(tg.rodrigues_to_rotation(torch.from_numpy(rod_t)), rot_j, 1e-5,
           "round trip")
    assert not rod_t[10].any()           # rod = 0 packs to exactly 0
    bad = np.full((2, 3, 3), np.nan, np.float32)
    bad[1] = np.inf
    assert not tg.rotation_to_rodrigues(torch.from_numpy(bad)).numpy().any()
    assert not np.asarray(jg.rotation_to_rodrigues(jnp.asarray(bad))).any()


def test_default_param_eps_and_inv_sigmoid_match_jax():
    np.testing.assert_array_equal(tg.default_param_eps(7),
                                  jg.default_param_eps(7))
    y = np.array([0.0, 1e-9, 0.3, 0.5, 0.9, 1.0], np.float32)
    np.testing.assert_allclose(tg.inv_sigmoid(torch.from_numpy(y)).numpy(),
                               np.asarray(jg.inv_sigmoid(jnp.asarray(y))),
                               rtol=1e-6)


# ---- the conditional free-flight solve and its VJP ------------------------

def test_conditional_solve_and_vjp_match_jax(pair):
    """solve_conditional_free_flight on JAX's own RayGaussians of 512
    random rays (misses included), targets conditioned to scatter: t
    within 1e-5 of its scale, and the VJP of a random cotangent into
    every float field and the target within 1e-4 of each field's
    largest cotangent, against jax.vjp."""
    _, jsc, _, _ = pair
    o, d, xi = random_rays(512, 4)
    jrg = jtrans.tau_coeffs(jsc.medium, jnp.asarray(o), jnp.asarray(d))
    p_scat = 1.0 - np.exp(-np.asarray(jtrans.tau_total(jrg)))
    target = (-np.log1p(-xi[:, 0] * p_scat * 0.999999)).astype(np.float32)
    g = np.random.default_rng(5).normal(size=512).astype(np.float32)
    t_j, vjp = jax.vjp(jsolvers.solve_conditional_free_flight, jrg,
                       jnp.asarray(target))
    g_rg_j, g_tgt_j = vjp(jnp.asarray(g))

    rg = ray_gaussians_from_numpy({k: np.asarray(getattr(jrg, k))
                                   for k in RayGaussians._fields})
    rg = RayGaussians(*(f if f.dtype == torch.bool
                        else f.requires_grad_(True) for f in rg))
    tgt = torch.from_numpy(target).requires_grad_(True)
    t = solve_conditional_free_flight(rg, tgt)
    _close(t.detach(), t_j, 1e-5, "t")
    t.backward(torch.from_numpy(g))
    assert (p_scat > 1e-6).sum() > 50
    _close(tgt.grad, g_tgt_j, 1e-4, "target cotangent")
    for k in RayGaussians._fields:
        if k == "hit":
            continue
        got = getattr(rg, k).grad
        got = torch.zeros(512, 1) if got is None else got
        want = np.asarray(getattr(g_rg_j, k))
        assert np.isfinite(got.numpy()).all(), k
        if np.abs(want).max() == 0:
            assert float(got.abs().max()) == 0.0, k
        else:
            _close(got, want, 1e-4, f"{k} cotangent")


# ---- the differentiable estimator ------------------------------------------

@pytest.mark.parametrize("candidate_k,rr_after", [(0, 0), (4, 0), (0, 1),
                                                  (4, 1)],
                         ids=["plain", "k4", "rr1", "k4_rr1"])
def test_radiance_diff_matches_jax(pair, candidate_k, rr_after):
    """multiscatter_radiance_diff at 16^2, 3 bounces, sample 1, seed 7,
    on the JAX package's scene: atol 1e-4, or where a lane's p_scat or
    RR test sits within rounding of its threshold,
    testing.CHUNK_BARS, as in test_xla_engine_matches_jax; and
    return_overflow's counts equal."""
    _, jsc, sc, _ = pair
    (jo, jd, jids), (o, d, ids) = _rays(16, 16)
    kw = dict(n_bounces=3, sample=1, seed=7, candidate_k=candidate_k,
              rr_after=rr_after, return_overflow=True)
    want, (j_over, j_live) = jax_diff(jsc, jo, jd, jids, None, **kw)
    got, (over, live) = multiscatter_radiance_diff(sc, o, d, ids, None, **kw)
    got, want = got.numpy(), np.asarray(want)
    assert np.isfinite(got).all() and got.std() > 0
    if np.abs(got - want).max() > 1e-4:
        res = image_agreement(got, want, 1)
        assert res["ok"], res
    assert (int(over), int(live)) == (int(j_over), int(j_live))
    assert (int(live) > 0) == (0 < candidate_k < sc.medium.n)


@pytest.fixture(scope="module")
def jax_losses():
    """The 10-Gaussian scene, and JAX's fit_loss value and gradient for
    each loss at 12^2, 2 bounces, seed 3 (target 0.4) on its packed
    vector."""
    jsc = jax_parse_gmm(SCENE10)
    jp = np.asarray(jsc.medium.pack_parameters())
    (jo, jd, jids), _ = _rays(12, 12)
    target = jnp.full((144, 3), 0.4, jnp.float32)
    # one jit for the three, so XLA compiles once
    out = jax.jit(lambda p: {loss: jax.value_and_grad(
        lambda q: jfit.fit_loss(q, jsc, jo, jd, jids, target, n_bounces=2,
                                loss=loss, seed=3))(p)
        for loss in ("l2", "l1", "l2_dual")})(jnp.asarray(jp))
    return port_scene(jsc), jp, {k: (float(v), np.asarray(g))
                                 for k, (v, g) in out.items()}


@pytest.mark.parametrize("loss", ["l2", "l1", "l2_dual"])
def test_fit_loss_and_gradient_match_jax(jax_losses, loss):
    """fit_loss and its autograd gradient on JAX's packed vector of the
    10-Gaussian scene against the JAX package's value and jax.grad, at
    testing.FIT_BARS."""
    sc, jp, want = jax_losses
    _, (o, d, ids) = _rays(12, 12)
    p = params_from_numpy(jp).requires_grad_(True)
    val = tfit.fit_loss(p, sc, o, d, ids, torch.full((144, 3), 0.4),
                        n_bounces=2, loss=loss, seed=3)
    val.backward()
    res = fit_agreement(val, p.grad, *want[loss])
    assert res["ok"], (res, FIT_BARS)


def test_fit_loss_refuses_an_unknown_loss():
    sc = port_scene(jax_parse_gmm(SCENE))
    _, (o, d, ids) = _rays(4, 4)
    with pytest.raises(ValueError, match="loss must be 'l2_dual', 'l2' or "
                       "'l1', got 'l3'"):
        tfit.fit_loss(sc.medium.pack_parameters(), sc, o, d, ids,
                      torch.zeros(16, 3), loss="l3")


def test_gradients_finite_at_rod_zero_misses_and_dead_lanes():
    """Axis-aligned Gaussians (rod = 0 exactly), rays that miss every
    Gaussian (half of them point away) and lanes that die at each of 3
    bounces: every loss's gradient is finite, with and without
    candidate_k and RR."""
    p = np.zeros((3, 11), np.float32)
    p[:, 0:3] = [[0.0, 1.0, 0.0], [0.3, 0.8, 0.1], [-0.4, 1.2, -0.2]]
    p[:, 6:9] = np.log([[0.1, 0.2, 0.15], [0.05, 0.3, 0.1],
                        [0.2, 0.2, 0.2]])
    p[:, 9] = np.log([2.0, 5.0, 0.5])
    sc = port_scene(jax_parse_gmm(SCENE))
    _, (o, d, ids) = _rays(8, 8)
    d = torch.cat([d[:32], -d[32:]])
    for loss in ("l2", "l1", "l2_dual"):
        for k, rr in ((0, 0), (2, 1)):
            params = torch.from_numpy(p.reshape(-1)).requires_grad_(True)
            val = tfit.fit_loss(params, sc, o, d, ids, torch.full((64, 3),
                                                                  0.3),
                                n_bounces=3, loss=loss, candidate_k=k,
                                rr_after=rr)
            val.backward()
            assert torch.isfinite(params.grad).all(), (loss, k, rr)
            assert float(params.grad.abs().sum()) > 0


def test_grad_matches_finite_differences():
    """The port's own version of tests/test_inverse.py
    test_grad_matches_finite_differences: central differences of the L2
    loss (fixed streams, so deterministic in params) along 6 random
    directions at eps 5e-4; at most one off by more than 20 %."""
    jsc = jax_parse_gmm(SCENE)
    sc = port_scene(jsc)
    p0 = np.asarray(jsc.medium.pack_parameters())
    _, (o, d, ids) = _rays(12, 12)
    target = torch.full((144, 3), 0.4)

    def loss(p):
        return tfit.fit_loss(p, sc, o, d, ids, target, n_bounces=2,
                             loss="l2")

    p = params_from_numpy(p0).requires_grad_(True)
    loss(p).backward()
    grad = p.grad.numpy()
    assert np.isfinite(grad).all()
    rng = np.random.default_rng(0)
    fails = 0
    with torch.no_grad():
        for _ in range(6):
            v = rng.normal(size=p0.shape).astype(np.float32)
            v /= np.linalg.norm(v)
            eps = 5e-4
            fd = (float(loss(torch.from_numpy(p0 + eps * v)))
                  - float(loss(torch.from_numpy(p0 - eps * v)))) / (2 * eps)
            ad = float(np.dot(grad, v))
            if abs(fd - ad) / max(abs(fd), abs(ad), 1e-3) > 0.2:
                fails += 1
    assert fails <= 1, f"{fails}/6 directional derivatives off"


# ---- Adam and checkpoints --------------------------------------------------

def test_adam_update_matches_optax():
    """torch.optim.Adam (the fit's optimizer) against optax.adam on the
    same gradient arrays for 6 steps, elements from 1e-9 to 10 in size,
    each step from the same parameters: the parameters within 2 ulp (2.4e-7
    relative) plus 2e-5 lr, the step counts equal and both moments within
    1e-6 of their scale.  optax forms the bias correction 1 - 0.999^t in
    float32 (1.3e-5 off at t = 1) and torch in float64, so the updates
    differ by up to ~7e-6 relative."""
    r = np.random.default_rng(9)
    p0 = r.normal(size=40).astype(np.float32)
    grads = [(r.normal(size=40) * 10.0 ** r.uniform(-9, 1, 40))
             .astype(np.float32) for _ in range(6)]
    lr = 1e-2
    opt = optax.adam(lr)
    jp = jnp.asarray(p0)
    st = opt.init(jp)
    p = torch.from_numpy(p0.copy()).requires_grad_(True)
    topt = torch.optim.Adam([p], lr=lr)
    for g in grads:
        with torch.no_grad():
            p.copy_(torch.from_numpy(np.asarray(jp)))
        upd, st = opt.update(jnp.asarray(g), st, jp)
        jp = optax.apply_updates(jp, upd)
        p.grad = torch.from_numpy(g)
        topt.step()
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(jp),
                                   rtol=2.4e-7, atol=2e-5 * lr)
        s = topt.state[p]
        count, mu, nu = jax.tree_util.tree_leaves(st)
        assert int(s["step"]) == int(count)
        _close(s["exp_avg"], mu, 1e-6, "mu")
        _close(s["exp_avg_sq"], nu, 1e-6, "nu")


# the checkpoint runs: 8^2 target of 0.4, 64-pixel batches, 2 bounces,
# spp 1, lr 1e-2, 4 iterations, a checkpoint after iterations 0 and 2
CKPT = dict(batch_pixels=64, n_bounces=2, spp=1)
CKPT_CFG = dict(max_iters=4, save_every=1, checkpoint_every=2)


def _jax_fit(out_dir, resume=None):
    """The JAX package's fit of SCENE on one device: (lines logged, the
    fitted scene's packed vector)."""
    logs = []
    fitted = jfit.fit_gaussians(
        jax_parse_gmm(SCENE), JCAM, np.full((8, 8, 3), 0.4, np.float32),
        JFitConfig(out_dir=str(out_dir), **CKPT_CFG),
        mesh=make_mesh(jax.devices()[:1]), log=logs.append, resume=resume,
        **CKPT)
    return logs, np.asarray(fitted.medium.pack_parameters())


def _port_fit(out_dir, resume=None):
    """The port's fit of SCENE, from JAX's packed vector."""
    jsc = jax_parse_gmm(SCENE)
    sc = port_scene(jsc).with_medium(tg.GaussianMixture.from_parameters(
        params_from_numpy(np.asarray(jsc.medium.pack_parameters()))))
    logs = []
    fitted = tfit.fit_gaussians(
        sc, CAM, np.full((8, 8, 3), 0.4, np.float32),
        FitConfig(out_dir=str(out_dir), **CKPT_CFG), log=logs.append,
        resume=resume, **CKPT)
    return logs, fitted.medium.pack_parameters().numpy()


def _losses(logs):
    return [float(s.split(" loss ")[1].split()[0]) for s in logs
            if " loss " in s]


def test_checkpoints_resume_across_packages(tmp_path):
    """The checkpoint the JAX package writes after iteration 2 of a
    4-iteration fit resumes in the port, and the one the port writes
    resumes in the JAX package; each resumed run's iteration 3 agrees
    with the uninterrupted run's: its loss within 1e-3 relative, and the
    parameters within 1e-3 (lr 1e-2: an element whose gradient sits at
    float noise may step the other way, by up to 2 lr, so those are left
    out: the elements the uninterrupted run's last step moved by more
    than lr / 2 must agree).  The npz layout: params, iteration, opt_0
    the step count (int32), opt_1 and opt_2 the moments."""
    jax_full = _jax_fit(tmp_path / "jax")
    port_full = _port_fit(tmp_path / "port")
    ckpts = {}
    for name in ("jax", "port"):
        path = str(tmp_path / name / "ckpt.npz")
        with np.load(path) as data:
            assert sorted(data.files) == ["iteration", "opt_0", "opt_1",
                                          "opt_2", "params"]
            assert data["opt_0"].dtype == np.int32
            assert (int(data["opt_0"]), int(data["iteration"])) == (3, 2)
            ckpts[name] = (path, data["params"].copy())
    resumed = {"jax": _port_fit(tmp_path / "to_port", ckpts["jax"][0]),
               "port": _jax_fit(tmp_path / "to_jax", ckpts["port"][0])}
    for name, (full_logs, full_p) in (("jax", jax_full),
                                      ("port", port_full)):
        logs, params = resumed[name]
        assert logs[0] == f"[fit] resumed {ckpts[name][0]} at iteration 3"
        np.testing.assert_allclose(_losses(logs), _losses(full_logs)[3:],
                                   rtol=1e-3)
        moved = np.abs(full_p - ckpts[name][1]) > 5e-3
        assert moved.mean() > 0.5
        np.testing.assert_allclose(params[moved], full_p[moved], atol=1e-3)


def test_short_fit_improves_render(tmp_path):
    """The port's version of tests/test_inverse.py
    test_short_fit_improves_render: fit a perturbed scene back toward a
    low-noise target rendered by the estimator (32 runs at an unrelated
    seed); the fitted scene's render must gain 2 dB over the perturbed
    one's.  40 iterations at the default lr 1e-2 and spp 2 (the JAX test
    runs 150 at lr 5e-3 and spp 4, and observed 33.8 -> 39.1 dB; these
    settings measured 32.8 -> 37.5 dB on the CPU, in a quarter of the
    time)."""
    scene_true = port_scene(jax_parse_gmm(SCENE))
    w = h = 16
    _, (o, d, ids) = _rays(w, h)
    with torch.no_grad():
        target = torch.stack([multiscatter_radiance_diff(
            scene_true, o, d, ids, None, n_bounces=2, sample=si,
            seed=987654321) for si in range(32)]).mean(0)
    target = target.numpy().reshape(h, w, 3)
    p = scene_true.medium.pack_parameters().numpy().copy()
    p += np.random.default_rng(5).normal(0, 0.08, p.shape).astype(np.float32)
    scene_init = scene_true.with_medium(
        tg.GaussianMixture.from_parameters(torch.from_numpy(p)))
    cfg = FitConfig(max_iters=40, save_every=100, checkpoint_every=0,
                    out_dir=str(tmp_path))
    fitted = tfit.fit_gaussians(scene_init, CAM, target, cfg,
                                batch_pixels=w * h, n_bounces=2,
                                log=lambda msg: None)
    rc = RenderConfig(width=w, height=h, spp=64)
    img = lambda sc: render_multiscatter(sc, CAM, rc, device="cpu")
    img_true = img(scene_true)
    p0, p1 = psnr(img(scene_init), img_true), psnr(img(fitted), img_true)
    assert p1 > p0 + 2.0, (p0, p1)


# ---- attribution and SFD -------------------------------------------------

ATTR_KW = dict(width=16, height=16, spp=2, max_bounces=4)


def test_pixel_attribution_matches_jax():
    """pixel_gaussians (as sets: top-k orders equal entries its own way),
    gaussian_pixel_counts and pixel_gaussians_paths (the multi-bounce
    recording over 2 paths a pixel, with candidate_k 4 too) against the
    JAX package's on the 10-Gaussian scene at 16^2."""
    jsc = jax_parse_gmm(SCENE10)
    sc = port_scene(jsc)
    jcfg = JConfig(ray_chunk=256, **ATTR_KW)
    cfg = RenderConfig(**ATTR_KW)
    j_idx, j_cnt = jattr.pixel_gaussians(jsc, JCAM, jcfg, k=6)
    idx, cnt = tattr.pixel_gaussians(sc, CAM, cfg, k=6)
    assert idx.shape == (256, 6) and idx.dtype == np.int32
    np.testing.assert_array_equal(cnt, j_cnt)
    assert cnt.max() > 1
    assert [set(r) for r in idx] == [set(r) for r in j_idx]
    # nearest entry first
    np.testing.assert_array_equal(idx[:, 0], j_idx[:, 0])
    np.testing.assert_array_equal(
        tattr.gaussian_pixel_counts(sc, CAM, cfg),
        jattr.gaussian_pixel_counts(jsc, JCAM, jcfg))
    for k_cand in (0, 4):
        j_idx, j_cnt = jattr.pixel_gaussians_paths(
            jsc, JCAM, jcfg.replace(candidate_k=k_cand), k=10)
        idx, cnt = tattr.pixel_gaussians_paths(
            sc, CAM, cfg.replace(candidate_k=k_cand), k=10)
        np.testing.assert_array_equal(cnt, j_cnt)
        np.testing.assert_array_equal(idx, j_idx)
        assert (cnt > tattr.pixel_gaussians(sc, CAM, cfg, k=10)[1]).any()


def _loss_8(sc, jsc):
    """The L1 fit_loss of tests/test_inverse.py _setup(w=h=8) in both
    packages."""
    (jo, jd, jids), (o, d, ids) = _rays(8, 8)
    jt, t = jnp.full((64, 3), 0.4, jnp.float32), torch.full((64, 3), 0.4)
    return (lambda p: jfit.fit_loss(p, jsc, jo, jd, jids, jt, n_bounces=2,
                                    loss="l1"),
            lambda p: tfit.fit_loss(p, sc, o, d, ids, t, n_bounces=2,
                                    loss="l1"))


def test_sfd_gradient_matches_jax_and_autodiff():
    """sfd_gradient with the same Rademacher generator as the JAX
    package's (seed 1, 64 samples, the default eps x 0.1) on JAX's packed
    vector: within 1e-2 relative L2 of the JAX package's estimate (loss
    differences at float rounding, divided by eps); and, as
    tests/test_inverse.py test_sfd_agrees_in_direction, its cosine with
    the autograd gradient above 0.3."""
    jsc = jax_parse_gmm(SCENE)
    sc = port_scene(jsc)
    jp = np.asarray(jsc.medium.pack_parameters())
    jloss, loss = _loss_8(sc, jsc)
    eps = tg.default_param_eps(2) * 0.1
    want = jsfd.sfd_gradient(jloss, jnp.asarray(jp), num_samples=64,
                             rng=np.random.default_rng(1), eps=eps)
    got = tsfd.sfd_gradient(loss, params_from_numpy(jp), num_samples=64,
                            rng=np.random.default_rng(1), eps=eps)
    assert got.dtype == np.float32 and np.isfinite(got).all()
    assert np.linalg.norm(got - want) <= 1e-2 * np.linalg.norm(want)
    p = params_from_numpy(jp).requires_grad_(True)
    loss(p).backward()
    grad = p.grad.numpy()
    cos = float(grad @ got / (np.linalg.norm(grad) * np.linalg.norm(got)))
    assert cos > 0.3, cos


def test_sfd_localized_agrees_with_autodiff():
    """The port's version of tests/test_inverse.py
    test_sfd_localized_agrees_with_autodiff: the union-footprint SFD
    (48 samples, eps x 0.1, footprints of k = 10) against autograd of the
    same sum-L1 loss on the 10-Gaussian scene at 8^2: cosine above 0.3;
    and footprint_fn refuses a k that would truncate a footprint."""
    sc = port_scene(jax_parse_gmm(SCENE10))
    _, (o, d, ids) = _rays(8, 8)
    params = sc.medium.pack_parameters()
    target = np.full((64, 3), 0.4, np.float32)

    def image(p):
        return multiscatter_radiance_diff(
            sc.with_medium(tg.GaussianMixture.from_parameters(p)), o, d,
            ids, None, n_bounces=2)

    p = params.clone().requires_grad_(True)
    torch.sum(torch.abs(image(p) - torch.from_numpy(target))).backward()
    grad = p.grad.numpy()
    cfg = RenderConfig(width=8, height=8)
    sfd = tsfd.sfd_gradient_localized(
        image, tsfd.footprint_fn(sc, CAM, cfg, k=10), params, target,
        num_samples=48, rng=np.random.default_rng(3),
        eps=tg.default_param_eps(10) * 0.1)
    assert np.isfinite(sfd).all()
    cos = float(grad @ sfd / (np.linalg.norm(grad) * np.linalg.norm(sfd)
                              + 1e-12))
    assert cos > 0.3, cos
    with pytest.raises(ValueError, match="footprint reaches"):
        tsfd.footprint_fn(sc, CAM, cfg, k=1)(params.numpy())
    fp = tsfd.footprint_fn(sc, CAM, cfg, k=10, paths=True, spp=2)
    assert fp(params.numpy()).shape == (64, 10)


# ---- cli fit --------------------------------------------------------------

def test_cli_fit_on_the_cpu(tmp_path, capsys):
    """`cli fit --device cpu` on a 10^2 target of the 10-Gaussian scene:
    3 iterations with snapshots every iteration; the losses logged and
    finite, the snapshots and final.ppm written, the note on --width."""
    scene = tmp_path / "scene.txt"
    scene.write_text(SCENE10)
    target = tmp_path / "target.ppm"
    write_ppm(str(target), np.full((10, 10, 3), 0.5, np.float32))
    out = tmp_path / "fit"
    res = cli.main(["fit", str(scene), "--target", str(target), "-o",
                    str(out), "--iters", "3", "--save-every", "1",
                    "--batch-pixels", "64", "--bounces", "2", "--spp", "2",
                    "--final-spp", "4", "--snapshots", "--width", "64",
                    "--device", "cpu"])
    printed = capsys.readouterr().out
    assert "--width/--height are ignored" in printed and "(10x10)" in printed
    assert [it for it, _ in res["losses"]] == [0, 1, 2]
    assert all(np.isfinite(v) for _, v in res["losses"])
    assert res["iterations"] == 3 and res["seconds"] > 0
    assert np.isfinite(res["params"]).all()
    assert res["paths"] == [str(out / f"iter_{i:04d}.ppm") for i in range(3)
                            ] + [str(out / "final.ppm")]
    for path in res["paths"]:
        assert read_ppm(path).shape == (10, 10, 3)
    assert os.path.exists(out / "ckpt.npz")


def test_scene_text_parses_back():
    """testing.scene_text writes a Scene that parses to the same
    mixture (how a fit's perturbed initial scene is written as GMM
    text)."""
    sc = parse_gmm(SCENE10)
    p = sc.medium.pack_parameters()
    sc = sc.with_medium(tg.GaussianMixture.from_parameters(p + 0.05))
    back = parse_gmm(scene_text(sc))
    _close(back.medium.cov, sc.medium.cov, 1e-6, "cov")
    _close(back.medium.mean, sc.medium.mean, 1e-7, "mean")
    _close(back.lights_i, sc.lights_i, 0, "lights")
    _close(back.medium.density, sc.medium.density, 1e-7, "density")
