"""The port's big-N dense engine on the CPU against gvr_tpu's: the Morton
order, the transposed table, the chunk plan, the plain versions of K4
(chunk-culled bounce) and K5 (chunk-streamed NEE) against
``bounce_step_pallas_big`` in interpret mode, the big-N wavefront against
``wavefront_pixels``, and the engine dispatch.

Inputs are made with numpy from seeds and handed to both packages; the
JAX scene crosses over as numpy arrays, so both pack the same table.  JAX's
kernels use an A&S erf within 1.5e-7 of torch.erf and sum in other orders;
each tolerance says what it allows for."""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_common import port_camera, port_scene, random_rays
from gvr_tpu.cameras import PinholeCamera as JPinhole
from gvr_tpu.config import RenderConfig as JConfig
from gvr_tpu.integrators.multiscatter import wavefront_pixels as jax_wavefront
from gvr_tpu.kernels import pathtrace_big as jpb
from gvr_tpu.scene.gaussians import morton_order as jax_morton_order
from gvr_tpu.scene.generators import random_gaussian_scene
from gvr_tpu.scene.scene import parse_gmm as jax_parse_gmm
from gvr_tpu_torch import cli
from gvr_tpu_torch.accel import grid as tgrid
from gvr_tpu_torch.cameras import PinholeCamera
from gvr_tpu_torch.config import RenderConfig
from gvr_tpu_torch.integrators.multiscatter import (engine_for,
                                                    render_multiscatter,
                                                    wavefront_pixels_big)
from gvr_tpu_torch.kernels import pathtrace_big as tpb
from gvr_tpu_torch.scene.gaussians import morton_order
from gvr_tpu_torch.scene.scene import MORTON_MIN_N, parse_gmm
from gvr_tpu_torch.testing import big_agreement

# test_pallas_kernels.test_big_kernel_matches_xla's scene, and one above
# MEGA_MAX_GAUSSIANS that the dense engine sends to K4/K5
SCENES = {600: dict(seed=2, diameter=(0.05, 0.2), density=(0.5, 2.0)),
          2100: dict(seed=0)}


def _text(n, lights=True):
    kw = dict(SCENES[n])
    if not lights:
        kw["lights"] = ()
    return random_gaussian_scene(n, **kw)


def test_morton_order_equals_jax():
    """The same permutation on random points and on points with ties
    (repeated and collinear), whose stable order decides the result."""
    r = np.random.default_rng(4)
    pts = r.uniform(-3.0, 5.0, (1000, 3)).astype(np.float32)
    ties = np.concatenate([np.repeat(pts[:50], 4, axis=0),
                           np.round(pts[:300] * 2.0) / 2.0,
                           np.zeros((20, 3), np.float32)])
    for p in (pts, ties, r.permutation(ties)):
        order = morton_order(p)
        assert np.array_equal(order, jax_morton_order(p))
        assert sorted(order.tolist()) == list(range(len(p)))


@pytest.mark.parametrize("n", [MORTON_MIN_N, 600])
def test_parse_gmm_sorts_as_jax(n):
    """Above 512 Gaussians both parsers Morton-sort; at 512 both keep the
    file order."""
    text = random_gaussian_scene(n, seed=3)
    got = parse_gmm(text).medium
    want = jax_parse_gmm(text).medium
    for k in ("mean", "density", "albedo"):
        assert np.array_equal(getattr(got, k).numpy(),
                              np.asarray(getattr(want, k))), k
    file_order = np.array([[float(v) for v in line.split()[1:4]]
                           for line in text.splitlines()
                           if line.startswith("g")], np.float32)
    assert np.array_equal(got.mean.numpy(), file_order) == (n <= 512)


@pytest.mark.parametrize("n", [600, 2100])
def test_pack_table_t_equals_jax(n):
    """[16, Np] with Np the next multiple of 256: rows 0-5 and 10-15 and
    the padding exactly equal; q and c0 (rows 6-9) are 3-term dots that
    XLA sums in another order, within 1 ulp of the row's magnitude."""
    sc = jax_parse_gmm(_text(n))
    want = np.asarray(jpb.pack_table_t(sc.medium))
    got = tpb.pack_table_t(port_scene(sc).medium).numpy()
    assert got.shape == want.shape == (16, -(-n // 256) * 256)
    exact = list(range(6)) + list(range(10, 16))
    assert np.array_equal(got[exact], want[exact])
    np.testing.assert_allclose(got[6:10], want[6:10], rtol=0,
                               atol=np.spacing(np.abs(want[6:10]).max()))
    assert tpb.pack_rows(port_scene(sc).medium).is_contiguous()


@pytest.mark.parametrize("n_chunks", [4, 24, 25, 40, 79, 96])
def test_plan_keeps_every_chunk(n_chunks):
    """JAX's scratch always covers every chunk (cap >= n_chunks); the
    port's chunk list is all of them."""
    _, cap = jpb.plan(n_chunks)
    assert tpb.plan(n_chunks) == n_chunks <= cap


def test_plan_refuses_97_chunks():
    for plan in (jpb.plan, tpb.plan):
        with pytest.raises(ValueError, match="engine='grid'"):
            plan(97)


@pytest.mark.parametrize("n_lights", [3, 0])
@pytest.mark.parametrize("n", [600, 2100])
def test_big_plain_matches_pallas(n, n_lights):
    """The plain K4 + K5 against bounce_step_pallas_big (interpret) on 256
    random rays, at testing.BIG_BARS, which also admit JAX's A&S erf: its
    1.5e-7 moves tau(t) by more than float32 rounding, and K4's inset
    Illinois step, which does not converge on a few rays, carries that
    into their root (one ray of 86 here lands 1.4e-4 away, within the t
    bar).  K4's own Newton step in both."""
    sc = jax_parse_gmm(_text(n, lights=n_lights > 0))
    o, d, xi = random_rays(256, seed=n)
    want = jpb.bounce_step_pallas_big(
        jpb.pack_table_t(sc.medium), jnp.asarray(o), jnp.asarray(d),
        jnp.asarray(xi), sc.lights_p, sc.lights_i, sc.env_color,
        solver_iters=12, interpret=True)
    tsc = port_scene(sc)
    assert tsc.lights().shape == (n_lights, 6)
    tpb.big_stage1_reference.launches = tpb.big_nee_reference.launches = 0
    got = tpb.bounce_step_big(tpb.pack_rows(tsc.medium),
                              *(torch.from_numpy(a) for a in (o, d, xi)),
                              tsc.lights(), tsc.env_color, 12)
    assert tpb.big_stage1_reference.launches == 1
    assert tpb.big_nee_reference.launches == 1
    res = big_agreement(got, want)
    assert res["ok"] and res["agree"] == 1.0, res


def test_big_bars_admit_float64_rounding():
    """BIG_BARS, which hold K4/K5 against their plain versions on the
    card, admit the plain version in float32 against itself in float64:
    they are no tighter than float32 rounding of the same math."""
    sc = parse_gmm(_text(2100))
    o, d, xi = (torch.from_numpy(a) for a in random_rays(512, seed=9))
    args = (tpb.pack_rows(sc.medium), o, d, xi, sc.lights(), sc.env_color)
    got = tpb.bounce_step_big(*args)
    want = tpb.bounce_step_big(*(a.double() for a in args))
    res = big_agreement(got, [w.float() if w.is_floating_point() else w
                              for w in want])
    assert res["ok"] and res["n_both"] > 50, res


def test_culling_stats_count_the_vote():
    """Per block of 64 rays, the chunks whose Gaussians any of its rays
    crosses: at least the chunks of any one ray's crossings, at most all;
    and per ray, the pairs it crosses."""
    sc = parse_gmm(_text(2100))
    table = tpb.pack_rows(sc.medium)
    o, d, _ = (torch.from_numpy(a) for a in random_rays(256, seed=1))
    hits, crossed = tpb.culling_stats(table, o, d)
    assert hits.shape == (4,) and crossed.shape == (256,)
    assert ((hits >= 1) & (hits <= table.shape[0] // tpb.G)).all()
    single, _ = tpb.culling_stats(table, o[:64], d[:64], block=1)
    assert int(hits[0]) >= int(single.max()) and int(single.max()) > 0
    assert int(crossed.sum()) >= int(single.sum()) > 0


def test_big_wavefront_matches_jax():
    """wavefront_pixels_big against JAX's wavefront_pixels at 2,100
    Gaussians, 16^2 spp 4, max_bounces 4 (JAX takes its big kernel there,
    interpreted): the same streams and estimator, so the bars of
    test_megakernel_midrange_matches_big_and_xla hold: median |diff| <
    1e-4 and image means within 0.5 % (a path whose scatter or RR test
    sits within rounding of its threshold moves its pixel by its whole
    radiance / spp)."""
    sc = jax_parse_gmm(_text(2100))
    jcam = JPinhole.create([0, 1, 6], [0, 1, 0], 0.25 * math.pi)
    ids = np.arange(256, dtype=np.int32)
    want = np.asarray(jax_wavefront(
        sc, jcam, JConfig(width=16, height=16, spp=4, max_bounces=4,
                          pallas="interpret"), jnp.asarray(ids)))
    stats = {}
    got = wavefront_pixels_big(
        port_scene(sc), port_camera(jcam),
        RenderConfig(width=16, height=16, spp=4, max_bounces=4),
        torch.from_numpy(ids), stats).numpy()
    assert np.isfinite(got).all() and got.std() > 0
    assert np.median(np.abs(got - want)) < 1e-4
    assert abs(got.mean() - want.mean()) < 5e-3 * want.mean()
    assert 4 <= stats["iterations"] <= 4 * 4 + 4
    assert int(stats["bounce_evals"]) >= 256 * 4


def _render_stats(text, cfg):
    stats = {}
    img = render_multiscatter(parse_gmm(text), PinholeCamera.create(
        [0, 1, 6], [0, 1, 0], 0.25 * math.pi), cfg, device="cpu",
        stats=stats)
    assert np.isfinite(img).all() and img.std() > 0
    return stats


def test_dense_engine_takes_big_above_mega_max():
    stats = _render_stats(_text(2100), RenderConfig(width=8, height=8,
                                                    spp=1, engine="dense"))
    assert (stats["engine"], stats["kernel"]) == ("dense", "big")
    assert stats["iterations"] > 0 and stats["bounce_evals"] >= 64
    stats = _render_stats(_text(600), RenderConfig(width=8, height=8, spp=1))
    assert (stats["engine"], stats["kernel"]) == ("dense", "mega")


def test_s_cap_fallback_takes_big(monkeypatch):
    """A grid whose densest cell exceeds S_CAP_MAX sends 'auto' to the
    dense engine, here the big-N kernels, as in the JAX package."""
    monkeypatch.setattr(tgrid, "S_CAP_MAX", 1)
    text = _text(2100)
    assert engine_for(RenderConfig(), parse_gmm(text).medium) == "dense"
    stats = _render_stats(text, RenderConfig(width=8, height=8, spp=1))
    assert (stats["engine"], stats["kernel"]) == ("dense", "big")


def test_dense_engine_refuses_above_96_chunks():
    text = random_gaussian_scene(96 * 256 + 1, seed=0)
    with pytest.raises(ValueError, match="engine='grid'"):
        render_multiscatter(parse_gmm(text), PinholeCamera.create(
            [0, 1, 6], [0, 1, 0], 0.25 * math.pi),
            RenderConfig(width=8, height=8, spp=1, engine="dense"),
            device="cpu")


def test_cli_renders_big(tmp_path, capsys):
    scene = tmp_path / "scene.txt"
    scene.write_text(_text(2100))
    out = tmp_path / "out.ppm"
    stats = cli.main(["render", str(scene), "-o", str(out), "--width", "8",
                      "--height", "8", "--spp", "1", "--engine", "dense",
                      "--stats", "--device", "cpu"])
    assert stats["kernel"] == "big" and stats["iterations"] > 0
    printed = capsys.readouterr().out
    assert "engine dense (big kernel)" in printed and "iterations" in printed
    assert out.stat().st_size > 0


def test_profile_render_takes_the_big_path():
    """The profiler tool on the big-N path on the CPU: its engine and
    kernel, and the wavefront's iterations."""
    from gvr_tpu_torch import profile_render
    res = profile_render.profile_render(gaussians=2100, size=8, spp=1,
                                        top=3, device="cpu", engine="dense")
    assert (res["engine"], res["kernel"]) == ("dense", "big")
    assert res["iterations"] > 0 and res["kernel_launches"] == 0
