"""The step wavefront (``RenderConfig(wavefront='step')``): the port's
``wavefront_pixels`` through K2's plain version, one launch a wavefront
iteration, against gvr_tpu's ``wavefront_pixels`` through the per-bounce
Pallas kernel in interpret mode (``_wavefront_planes_step``) and against
the port's megakernel plain version; the dense engine's dispatch against
the JAX package's thresholds.

Bar against JAX: atol 1e-4 on every pixel, the port's megakernel bar
(tests/test_torch_megatrace.py).  It is looser than JAX's own
step-against-mega bar of 1e-5 (test_megakernel_matches_step_wavefront)
because torch's erf/erfinv round apart from XLA's."""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_common import port_camera, port_scene
from gvr_tpu.cameras import PinholeCamera as JPinhole
from gvr_tpu.config import RenderConfig as JConfig
from gvr_tpu.integrators.multiscatter import wavefront_pixels as jax_wavefront
from gvr_tpu.kernels.pathtrace import mega_supported_n, pallas_supported_n
from gvr_tpu.scene.generators import random_gaussian_scene
from gvr_tpu.scene.scene import parse_gmm as jax_parse_gmm
from gvr_tpu_torch.cameras import PinholeCamera
from gvr_tpu_torch.config import RenderConfig
from gvr_tpu_torch.integrators import multiscatter as tms
from gvr_tpu_torch.integrators.multiscatter import (dense_kernel,
                                                    render_multiscatter,
                                                    tile_ids,
                                                    wavefront_pixels,
                                                    wavefront_pixels_step)
from gvr_tpu_torch.kernels import megatrace as tmt
from gvr_tpu_torch.kernels import pathtrace as tpt
from gvr_tpu_torch.scene.gaussians import R_CUT
from gvr_tpu_torch.scene.scene import parse_gmm
from gvr_tpu_torch.testing import (BOUNCE_BARS, CHUNK_BARS, PATH_BOUNCE_BARS,
                                   bounce_agreement, image_agreement)

# test_megakernel_matches_step_wavefront's configuration: 24 Gaussians
# (seed 7), 16^2, spp 9 (n_strat 3), max_bounces 6
SMALL = dict(diameter=(0.2, 0.6), density=(0.5, 2.0))
KW = dict(width=16, height=16, spp=9, max_bounces=6)


def _scene(n_lights=3, n=24):
    return jax_parse_gmm(random_gaussian_scene(
        n, seed=7, **SMALL, **({} if n_lights else {"lights": ()})))


def _jcam():
    return JPinhole.create([0, 1, 6], [0, 1, 0], 0.25 * math.pi)


@pytest.mark.parametrize("n_lights", [3, 0])
def test_step_wavefront_matches_jax(n_lights):
    """With the generator's 3 point lights and without; K2's plain version
    once an iteration and no other bounce."""
    sc, cam = _scene(n_lights), _jcam()
    want = np.asarray(jax_wavefront(
        sc, cam, JConfig(wavefront="step", pallas="interpret",
                         pool_regen=False, **KW),
        jnp.arange(256, dtype=jnp.int32)))
    before = (tpt.bounce_core_reference.launches, tmt.mega_reference.launches)
    got = wavefront_pixels(port_scene(sc), port_camera(cam),
                           RenderConfig(wavefront="step", **KW),
                           torch.arange(256, dtype=torch.int32)).numpy()
    assert got.shape == (256, 3) and np.isfinite(got).all() and got.std() > 0
    np.testing.assert_allclose(got, want, atol=1e-4)
    assert tpt.bounce_core_reference.launches > before[0]
    assert tmt.mega_reference.launches == before[1]


def test_step_wavefront_matches_mega_reference():
    """The step wavefront and the megakernel's plain version trace the same
    paths with the same streams: the image within CHUNK_BARS (the sums'
    order differs) and the same bounce evaluations."""
    sc, cam = _scene(), _jcam()
    ts, tc = port_scene(sc), port_camera(cam)
    ids = torch.arange(256, dtype=torch.int32)
    cfg = RenderConfig(**KW)
    sums, counts = tmt.mega_reference(
        tmt.camera_vector(tc), tpt.pack_table(ts.medium), ids, cfg,
        ts.lights(), ts.env_color, True)
    stats = {}
    got = wavefront_pixels_step(ts, tc, cfg.replace(wavefront="step"), ids,
                                stats).numpy()
    res = image_agreement(got, (sums / cfg.spp).numpy(), cfg.spp)
    assert res["ok"], (res, CHUNK_BARS)
    n_ref = int(counts.sum())
    assert abs(stats["bounce_evals"] - n_ref) <= CHUNK_BARS["evals_rel"] \
        * n_ref


def test_wavefront_must_be_mega_or_step():
    """JAX's check and message (gvr_tpu/config.py:155-160)."""
    assert RenderConfig().wavefront == "mega"
    assert RenderConfig(wavefront="step").wavefront == "step"
    with pytest.raises(ValueError, match="wavefront must be 'mega' or "
                       "'step', got 'Mega'"):
        RenderConfig(wavefront="Mega")


@pytest.mark.parametrize("n", [1, 24, 250, 256, 257, 300, 2048, 2049])
@pytest.mark.parametrize("wavefront", ["mega", "step"])
def test_dense_kernel_follows_jax(wavefront, n):
    """The dense engine's kernel path by N as JAX's wavefront_pixels picks
    it (gvr_tpu/integrators/multiscatter.py:488-503): the megakernel up to
    2,048 Gaussians under 'mega', the step wavefront while the padded
    table holds at most 256 rows under 'step', the big-N kernels
    otherwise."""
    use_mega = wavefront == "mega" and mega_supported_n(n)
    use_big = not use_mega and not pallas_supported_n(n)
    want = "mega" if use_mega else "big" if use_big else "step"
    assert dense_kernel(RenderConfig(wavefront=wavefront), n) == want


def _render(n, **kw):
    stats = {}
    img = render_multiscatter(
        parse_gmm(random_gaussian_scene(n, seed=0, **SMALL)),
        PinholeCamera.create([0, 1, 6], [0, 1, 0], 0.25 * math.pi),
        RenderConfig(wavefront="step", **kw), device="cpu", stats=stats)
    assert img.shape == (kw["height"], kw["width"], 3)
    assert np.isfinite(img).all() and img.std() > 0
    return img, stats


def test_render_takes_the_step_path():
    """render_multiscatter under 'step' at 24 Gaussians: kernel 'step', K2's
    plain version once a wavefront iteration, the megakernel's never, and
    spp <= iterations <= spp * max_bounces + max_bounces."""
    counted = (tpt.bounce_core_reference, tmt.mega_reference)
    before = [fn.launches for fn in counted]
    kw = dict(width=16, height=16, spp=4, max_bounces=6)
    _, stats = _render(24, **kw)
    assert (stats["engine"], stats["kernel"]) == ("dense", "step")
    assert [fn.launches - b for fn, b in zip(counted, before)] == [
        stats["iterations"], 0]
    assert kw["spp"] <= stats["iterations"] \
        <= kw["spp"] * kw["max_bounces"] + kw["max_bounces"]
    assert stats["bounce_evals"] >= 256 * kw["spp"]


def test_render_step_above_256_takes_big():
    """Above MAX_PALLAS_GAUSSIANS 'step' takes the big-N kernels, as in
    JAX, and K2 does not run."""
    before = tpt.bounce_core_reference.launches
    _, stats = _render(300, width=8, height=8, spp=1)
    assert (stats["engine"], stats["kernel"]) == ("dense", "big")
    assert stats["iterations"] > 0
    assert tpt.bounce_core_reference.launches == before


def test_profile_render_takes_the_step_path():
    """profile_render --wavefront step on the CPU: its kernel and the
    wavefront's iterations."""
    from gvr_tpu_torch import profile_render
    res = profile_render.main(["--gaussians", "24", "--size", "8", "--spp",
                               "1", "--top", "3", "--device", "cpu",
                               "--wavefront", "step"])
    assert (res["engine"], res["kernel"]) == ("dense", "step")
    assert res["iterations"] > 0 and res["kernel_launches"] == 0


def test_grazing_pairs_part_float32_from_float64(monkeypatch):
    """Why K2 is held to PATH_BOUNCE_BARS on the step path's own rays
    (test_torch_cuda.py): on the inputs of its first launch on the
    headline's chunk 9 (65,536 camera rays) the plain version in float32
    against itself in float64 misses BOUNCE_BARS' every-ray tau bar, so no
    two float32 versions can be held to it there.  Every ray beyond that
    bar crosses a Gaussian near the R_CUT clip (R_CUT^2 - m2 < 5e-2, in
    float64, which magnifies m2's rounding at least 90-fold), fewer than
    128 rays do, and over the whole launch the float32 version meets
    PATH_BOUNCE_BARS' count and cap."""
    sc = parse_gmm(random_gaussian_scene(250, seed=0))
    cam = PinholeCamera.create([0, 1, 6], [0, 1, 0], math.radians(45.0))
    cfg = RenderConfig(width=1024, height=1024, spp=64, wavefront="step")
    ids = tile_ids(1024, 1024, "cpu")[9 * 65536:10 * 65536]
    calls = []

    class First(Exception):
        pass

    def record(*args):
        calls.append(args)
        raise First

    monkeypatch.setattr(tms, "bounce_step", record)
    with pytest.raises(First):
        wavefront_pixels_step(sc, cam, cfg, ids)
    table, o, d, xi, lights, env = (a.contiguous() for a in calls[0][:6])
    n_rays = o.shape[0]
    assert n_rays == 65536
    col = lambda f: table.double()[:, f:f + 1]
    grazing, r32, r64 = [], [], []
    for s in range(0, n_rays, 8192):
        ray = [v.double()[s:s + 8192, k][None, :] for v in (o, d)
               for k in range(3)]
        a, b = tpt._coeffs(col, *ray)
        _, _, m2, ok = tpt._interval(col, *ray, a, b)
        grazing.append((ok & (R_CUT ** 2 - m2 < 5e-2)).any(0))
        args = (table, o[s:s + 8192], d[s:s + 8192], xi[s:s + 8192], lights,
                env)
        r32.append(tpt.bounce_core_reference(*args))
        r64.append([x.float() if x.is_floating_point() else x
                    for x in tpt.bounce_core_reference(
                        *(a.double() for a in args))])
    grazing = torch.cat(grazing)
    r32, r64 = ([torch.cat([r[k] for r in rs]) for k in range(5)]
                for rs in (r32, r64))
    res = bounce_agreement(r32, r64, BOUNCE_BARS)
    assert res["tau_excess"] > 0.0 and not res["ok"], res
    beyond = ((r32[4] - r64[4]).abs() > BOUNCE_BARS["tau_atol"]
              + BOUNCE_BARS["tau_rtol"] * r64[4].abs())
    assert int(beyond.sum()) == res["tau_beyond"]
    assert 0 < int(grazing.sum()) < 128
    assert not (beyond & ~grazing).any()
    res = bounce_agreement(r32, r64, PATH_BOUNCE_BARS)
    assert res["ok"], (res, PATH_BOUNCE_BARS)


@pytest.mark.parametrize("misses,dtau,ok", [
    (PATH_BOUNCE_BARS["tau_misses"], 1e-2, True),
    (PATH_BOUNCE_BARS["tau_misses"] + 1, 1e-2, False),
    (1, 2.0 * PATH_BOUNCE_BARS["tau_cap"], False)])
def test_path_bounce_bars_cap_the_tau_misses(misses, dtau, ok):
    """PATH_BOUNCE_BARS lets tau miss its bar on at most tau_misses rays,
    and on none by more than tau_cap; each other bar is BOUNCE_BARS'."""
    rng = np.random.default_rng(0)
    n = 4096
    t = rng.uniform(0.5, 5.0, n).astype(np.float32)
    sc = rng.uniform(size=n) < 0.5
    alb = rng.uniform(size=n).astype(np.float32)
    li = rng.uniform(size=(n, 3)).astype(np.float32)
    tau = rng.uniform(0.1, 3.0, n).astype(np.float32)
    off = tau.copy()
    off[:misses] += dtau
    res = bounce_agreement((t, sc, alb, li, off), (t, sc, alb, li, tau),
                           PATH_BOUNCE_BARS)
    assert res["tau_beyond"] == misses
    assert res["ok"] == ok, res
    assert not bounce_agreement((t, sc, alb, li, off), (t, sc, alb, li, tau),
                                BOUNCE_BARS)["ok"]
