"""The port's forward integrators on the CPU against the JAX package's:
the dense XLA engine of render_multiscatter (every non-kernel solver and
candidate_k), the per-path loop, single scatter, both ray marchers, the
hit mask and path_statistics, each on the same scene, camera and seed;
then the port's own versions of the JAX package's closed-form and
cross-integrator tests (tests/test_integrators.py, test_raymarch_extra.py)
and the render CLI with every integrator and solver."""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_common  # noqa: F401  (sets torch threads)
from _torch_common import port_camera, port_scene
from gvr_tpu.cameras import OrthographicCamera as JOrtho
from gvr_tpu.cameras import PinholeCamera as JPinhole
from gvr_tpu.config import RenderConfig as JConfig
from gvr_tpu.config import Solver as JSolver
from gvr_tpu.integrators import multiscatter as jms
from gvr_tpu.integrators.freeflight import \
    render_single_scatter as jax_single
from gvr_tpu.integrators.raymarch import march_transmittance as jax_march
from gvr_tpu.integrators.raymarch import render_pure_raymarch as jax_pure
from gvr_tpu.integrators.raymarch import \
    render_raymarch_gaussians as jax_raymarch
from gvr_tpu.integrators.test_hit import render_hit_mask as jax_hit_mask
from gvr_tpu.scene.generators import random_gaussian_scene
from gvr_tpu.scene.scene import parse_gmm as jax_parse_gmm
from gvr_tpu.utils.profiling import path_statistics as jax_path_statistics
from gvr_tpu_torch import cli
from gvr_tpu_torch.cameras import PinholeCamera, pixel_center_uv
from gvr_tpu_torch.config import RenderConfig, Solver
from gvr_tpu_torch.integrators import multiscatter as tms
from gvr_tpu_torch.integrators.freeflight import render_single_scatter
from gvr_tpu_torch.integrators.raymarch import (march_transmittance,
                                                render_pure_raymarch,
                                                render_raymarch_gaussians)
from gvr_tpu_torch.integrators.test_hit import render_hit_mask
from gvr_tpu_torch.io.ppm import read_ppm
from gvr_tpu_torch.ops.transmittance import transmittance_up_to
from gvr_tpu_torch.scene.scene import parse_gmm
from gvr_tpu_torch.testing import image_agreement
from gvr_tpu_torch.utils.profiling import path_statistics

SCENE24 = random_gaussian_scene(24, seed=7, diameter=(0.2, 0.6),
                                density=(0.5, 2.0))
XLA_KW = dict(width=16, height=16, spp=9, max_bounces=6)
# the JAX package pads every chunk to cfg.ray_chunk rays; a small chunk
# keeps its reference renders of a 16^2 image short
SMALL = dict(width=16, height=16, ray_chunk=256)


def _cams(camera: str):
    if camera == "pinhole":
        return (JPinhole.create([0, 1, 6], [0, 1, 0], 0.25 * math.pi),
                PinholeCamera.create([0, 1, 6], [0, 1, 0], 0.25 * math.pi))
    jcam = JOrtho.create([0, 1, 6], [0, 1, 0])
    return jcam, port_camera(jcam)


def _images_agree(got, want, spp: int):
    """atol 1e-4 on every pixel, or where a path's scatter or RR test sits
    within rounding of its threshold, testing.CHUNK_BARS."""
    assert got.shape == want.shape and got.dtype == np.float32
    assert np.isfinite(got).all() and got.std() > 0
    if np.abs(got - want).max() <= 1e-4:
        return
    res = image_agreement(got, want, spp)
    assert res["ok"], res


@pytest.mark.parametrize("solver,k", [("bisection", 0),
                                      ("analytic_bisection", 0),
                                      ("uniform", 0), ("bisection", 8)],
                         ids=["bisection", "analytic_bisection", "uniform",
                              "bisection_k8"])
def test_xla_engine_matches_jax(solver, k):
    """render_multiscatter with a non-kernel solver takes the XLA engine,
    as the JAX package does on any backend: 16^2 spp 9, 24 Gaussians,
    max_bounces 6."""
    jcam, tcam = _cams("pinhole")
    kw = dict(XLA_KW, candidate_k=k)
    want = jms.render_multiscatter(jax_parse_gmm(SCENE24), jcam,
                                   JConfig(solver=JSolver(solver), **kw))
    stats = {}
    got = tms.render_multiscatter(parse_gmm(SCENE24), tcam,
                                  RenderConfig(solver=Solver(solver), **kw),
                                  device="cpu", stats=stats)
    assert (stats["engine"], stats["kernel"]) == ("dense", "xla")
    assert stats["iterations"] > 0 and stats["chunk"] == 256
    _images_agree(got, want, 9)


@pytest.mark.parametrize("camera", ["pinhole", "orthographic"])
def test_xla_engine_newton_candidate_k_matches_jax(camera):
    """The XLA wavefront with NEWTON and candidate_k=8 (which the JAX
    package runs on the CPU, where its kernels are off), tile-ordered."""
    jcam, tcam = _cams(camera)
    cfg = dict(XLA_KW, candidate_k=8, solver_finisher=True)
    want = jms.render_multiscatter(jax_parse_gmm(SCENE24), jcam,
                                   JConfig(**cfg))
    ids = torch.from_numpy(tms.tile_order(16, 16))
    img = torch.zeros((256, 3))
    img[ids] = tms.wavefront_pixels_xla(parse_gmm(SCENE24), tcam,
                                        RenderConfig(**cfg), ids)
    _images_agree(img.numpy().reshape(16, 16, 3), want, 9)


def test_per_path_loop_and_camera_rays_match_jax():
    """mc_camera_rays and multiscatter_radiance (the per-path loop) on 256
    pixels at sample 3."""
    jcam, tcam = _cams("pinhole")
    jsc = jax_parse_gmm(SCENE24)
    jcfg, cfg = JConfig(**XLA_KW), RenderConfig(**XLA_KW)
    ids = np.arange(256, dtype=np.int32)
    jo, jd, _ = jms.mc_camera_rays(jsc, jcam, jcfg, jnp.asarray(ids),
                                   jnp.int32(3))
    o, d, _ = tms.mc_camera_rays(port_scene(jsc), tcam, cfg,
                                 torch.from_numpy(ids), 3)
    np.testing.assert_allclose(o.numpy(), np.asarray(jo), atol=1e-6)
    np.testing.assert_allclose(d.numpy(), np.asarray(jd), atol=1e-6)
    want = jms.multiscatter_radiance(jsc, jo, jd, jnp.asarray(ids), jcfg,
                                     sample=3)
    got = tms.multiscatter_radiance(port_scene(jsc), torch.tensor(
        np.asarray(jo)), torch.tensor(np.asarray(jd)),
        torch.from_numpy(ids), cfg, sample=3)
    _images_agree(got.numpy(), np.asarray(want), 1)


@pytest.mark.parametrize("solver,k", [("analytic_newton", 0),
                                      ("bisection", 4)],
                         ids=["analytic_newton", "bisection_k4"])
def test_single_scatter_matches_jax(solver, k):
    jcam, tcam = _cams("pinhole")
    kw = dict(SMALL, spp=4, candidate_k=k)
    want = jax_single(jax_parse_gmm(SCENE24), jcam,
                      JConfig(solver=JSolver(solver), **kw))
    stats = {}
    got = render_single_scatter(parse_gmm(SCENE24), tcam,
                                RenderConfig(solver=Solver(solver), **kw),
                                device="cpu", stats=stats)
    assert stats["k3_launches"] == 8 and stats["paths"] == 1024
    _images_agree(got, want, 4)


@pytest.mark.parametrize("camera", ["pinhole", "orthographic"])
def test_raymarch_matches_jax(camera):
    """The analytic marcher at step 0.02 with 4 environment samples:
    rtol 1e-4 / atol 1e-5 on every pixel."""
    jcam, tcam = _cams(camera)
    kw = dict(SMALL, step_size=0.02, env_samples=4)
    want = jax_raymarch(jax_parse_gmm(SCENE24), jcam, JConfig(**kw))
    stats = {}
    got = render_raymarch_gaussians(parse_gmm(SCENE24), tcam,
                                    RenderConfig(**kw), device="cpu",
                                    stats=stats)
    assert got.std() > 0 and 0 < stats["steps"] < stats["n_steps"]
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


def test_pure_raymarch_matches_jax():
    """The pure marcher at step 0.1 with 2 environment samples: rtol
    1e-4 / atol 1e-5 on every pixel."""
    jcam, tcam = _cams("pinhole")
    kw = dict(SMALL, step_size=0.1, env_samples=2)
    want = jax_pure(jax_parse_gmm(SCENE24), jcam, JConfig(**kw))
    stats = {}
    got = render_pure_raymarch(parse_gmm(SCENE24), tcam, RenderConfig(**kw),
                               device="cpu", stats=stats)
    assert got.std() > 0 and stats["shadow_steps"] > stats["n_steps"] // 2
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


def test_march_transmittance_matches_jax():
    """Marched transmittance of 64 rays from inside the medium up to
    tmax 0.1-4: rtol 1e-4 / atol 1e-6."""
    jsc = jax_parse_gmm(SCENE24)
    r = np.random.default_rng(4)
    o = (r.uniform(-0.5, 0.5, (64, 3)) + [0.0, 1.0, 0.0]).astype(np.float32)
    d = r.normal(size=(64, 3))
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    tmax = r.uniform(0.1, 4.0, 64).astype(np.float32)
    want = jax_march(jsc.medium, jnp.asarray(o), jnp.asarray(d),
                     jnp.asarray(tmax), 0.01, 500)
    got = march_transmittance(port_scene(jsc).medium, torch.from_numpy(o),
                              torch.from_numpy(d), torch.from_numpy(tmax),
                              0.01, 500)
    assert got.min() < 0.99
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-6)


@pytest.mark.parametrize("camera", ["pinhole", "orthographic"])
def test_hit_mask_matches_jax(camera):
    jcam, tcam = _cams(camera)
    want = jax_hit_mask(jax_parse_gmm(SCENE24), jcam, JConfig(**SMALL))
    got = render_hit_mask(parse_gmm(SCENE24), tcam, RenderConfig(**SMALL),
                          device="cpu")
    assert np.array_equal(got, np.asarray(want))
    assert 0 < (got[..., 1] < 0.5).mean() < 1


@pytest.mark.parametrize("solver", ["analytic_newton", "uniform"])
def test_path_statistics_matches_jax(solver):
    jcam, tcam = _cams("pinhole")
    kw = dict(width=32, height=32, solver=solver)
    want = jax_path_statistics(jax_parse_gmm(SCENE24), jcam,
                               JConfig(**dict(kw, solver=JSolver(solver))),
                               512)
    got = path_statistics(parse_gmm(SCENE24), tcam,
                          RenderConfig(**dict(kw, solver=Solver(solver))),
                          512, device="cpu")
    assert got == pytest.approx(want, rel=1e-6)
    assert got["rays_per_path"] > 1


# ---- the JAX package's closed-form and cross-integrator tests ---------

ABSORB_SCENE = "g 0 1 0  0.08 0.01 0  0.06 0 0.1  2.0 0.0\n"   # albedo 0
SCATTER_SCENE = ("l 0 4 0  30 30 30\n"
                 "g 0 1 0  0.08 0.01 0  0.06 0 0.1  1.5 0.8\n")
CAM = PinholeCamera.create([0, 1, 6], [0, 1, 0], 0.25 * math.pi)
W = H = 24


def _closed_form_absorption(scene, w, h):
    """Pure absorption and the environment only: L = T(inf) * env."""
    o, d = CAM.sample_ray(pixel_center_uv(w, h).reshape(-1, 2))
    tr = transmittance_up_to(scene.medium, o, d, 1e8)
    return (tr[:, None] * scene.env_color).numpy().reshape(h, w, 3)


def test_hit_mask_center_and_corner():
    img = render_hit_mask(parse_gmm(ABSORB_SCENE), CAM,
                          RenderConfig(width=W, height=H), device="cpu")
    np.testing.assert_allclose(img[H // 2, W // 2], [1, 0, 1], atol=1e-6)
    np.testing.assert_allclose(img[0, 0], [0.53, 0.81, 0.92], atol=1e-6)
    assert 0.0 < (img[..., 1] < 0.5).mean() < 1.0


def test_raymarch_pure_absorption_closed_form():
    sc = parse_gmm(ABSORB_SCENE)
    cfg = RenderConfig(width=W, height=H, env_samples=1, step_size=0.01)
    img = render_raymarch_gaussians(sc, CAM, cfg, device="cpu")
    np.testing.assert_allclose(img, _closed_form_absorption(sc, W, H),
                               atol=5e-3)


@pytest.mark.parametrize("solver", ["bisection", "uniform"])
def test_multiscatter_pure_absorption_statistics(solver):
    """Albedo 0 ends a path at its first scatter: E[L] = T(inf) env."""
    sc = parse_gmm(ABSORB_SCENE)
    cfg = RenderConfig(width=W, height=H, spp=144, solver=Solver(solver))
    img = tms.render_multiscatter(sc, CAM, cfg, device="cpu")
    assert np.abs(img - _closed_form_absorption(sc, W, H)).mean() < 0.02


def test_single_scatter_matches_multiscatter_thin():
    sc = parse_gmm("l 0 4 0  30 30 30\n"
                   "g 0 1 0  0.08 0.01 0  0.06 0 0.1  0.4 0.3\n")
    cfg = RenderConfig(width=W, height=H, spp=256)
    ss = render_single_scatter(sc, CAM, cfg, device="cpu")
    ms = tms.render_multiscatter(sc, CAM, cfg.replace(seed=7), device="cpu")
    assert np.abs(ss - ms).mean() < 0.01


@pytest.mark.parametrize("solver", ["bisection", "analytic_bisection"])
def test_solver_choice_does_not_change_image(solver):
    """The XLA engine's exact solvers against the plain megakernel's
    Newton at 40 steps, same seed."""
    sc = parse_gmm(SCATTER_SCENE)
    cfg = RenderConfig(width=16, height=16, spp=32, solver=Solver(solver))
    img = tms.render_multiscatter(sc, CAM, cfg, device="cpu")
    ref = tms.render_multiscatter(sc, CAM, cfg.replace(
        solver=Solver.NEWTON, solver_iters=40), device="cpu")
    diff = np.abs(img - ref)
    assert diff.mean() < 1e-3, diff.mean()
    assert (diff < 2e-3).mean() > 0.98


def test_pure_raymarch_matches_analytic_marcher():
    sc = parse_gmm("g 0 1 0  0.08 0.01 0  0.06 0 0.1  1.0 0.0\n")
    cfg = RenderConfig(width=16, height=16, env_samples=1, step_size=0.02)
    a = render_pure_raymarch(sc, CAM, cfg, device="cpu")
    b = render_raymarch_gaussians(sc, CAM, cfg, device="cpu")
    np.testing.assert_allclose(a, b, atol=0.03)


def test_marchers_without_shadow_rays():
    """No light and no environment sample: a step has no shadow ray, and
    both marchers reduce to T(inf) * env on a pure absorber."""
    sc = parse_gmm(ABSORB_SCENE)
    cfg = RenderConfig(width=12, height=12, env_samples=0, step_size=0.02)
    want = _closed_form_absorption(sc, 12, 12)
    np.testing.assert_allclose(
        render_raymarch_gaussians(sc, CAM, cfg, device="cpu"), want,
        atol=5e-3)
    np.testing.assert_allclose(
        render_pure_raymarch(sc, CAM, cfg, device="cpu"), want, atol=0.03)


def test_marched_transmittance_converges_to_analytic():
    r = np.random.default_rng(5)
    sc = parse_gmm(SCENE24)
    o = torch.tensor(r.uniform(-0.5, 0.5, (16, 3)) + [0.0, 1.0, 0.0],
                     dtype=torch.float32)
    d = torch.nn.functional.normalize(
        torch.tensor(r.normal(size=(16, 3)), dtype=torch.float32), dim=-1)
    tmax = torch.full((16,), 4.0)
    exact = transmittance_up_to(sc.medium, o, d, tmax)
    approx = march_transmittance(sc.medium, o, d, tmax, 0.002, 2001)
    np.testing.assert_allclose(approx.numpy(), exact.numpy(), atol=0.02)


# ---- the render CLI ---------------------------------------------------

@pytest.mark.parametrize("integrator,extra", [
    ("singlescatter", []), ("raymarch", ["--step-size", "0.05"]),
    ("pureraymarch", ["--step-size", "0.2", "--env-samples", "1"]),
    ("hitmask", []), ("multiscatter", ["--solver", "bisection"]),
    ("multiscatter", ["--solver", "analytic_bisection"]),
    ("multiscatter", ["--solver", "uniform"])],
    ids=["singlescatter", "raymarch", "pureraymarch", "hitmask",
         "bisection", "analytic_bisection", "uniform"])
def test_cli_renders_every_integrator_and_solver(tmp_path, capsys,
                                                 integrator, extra):
    scene = tmp_path / "scene.txt"
    scene.write_text(SCENE24)
    out = tmp_path / "out.ppm"
    stats = cli.main(["render", str(scene), "-o", str(out), "--width", "8",
                      "--height", "8", "--spp", "2", "--integrator",
                      integrator, "--stats", "--device", "cpu"] + extra)
    img = read_ppm(str(out))
    assert img.shape == (8, 8, 3) and img.std() > 0
    printed = capsys.readouterr().out
    assert "wrote" in printed and "[render]" in printed
    assert stats["device"] == "cpu" and stats["chunk"] >= 256
    if integrator == "multiscatter":
        assert (stats["engine"], stats["kernel"]) == ("dense", "xla")
