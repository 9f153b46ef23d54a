"""The slice end to end: the port's render_multiscatter and render CLI on
the CPU against gvr_tpu's render_multiscatter (CPU, XLA path)."""

import functools
import math

import numpy as np
import pytest
import torch

import _torch_common  # noqa: F401  (sets torch threads)
from gvr_tpu.cameras import OrthographicCamera as JOrtho
from gvr_tpu.cameras import PinholeCamera as JPinhole
from gvr_tpu.config import RenderConfig as JConfig
from gvr_tpu.config import Solver as JSolver
from gvr_tpu.integrators import multiscatter as jms
from gvr_tpu.integrators.multiscatter import \
    render_multiscatter as jax_render
from gvr_tpu.integrators.multiscatter import tile_order as jax_tile_order
from gvr_tpu.integrators.raymarch import render_raymarch_spheres
from gvr_tpu.kernels.pathtrace import mega_supported_n, pallas_supported_n
from gvr_tpu.scene.generators import random_gaussian_scene
from gvr_tpu.scene.scene import parse_gmm as jax_parse_gmm
from gvr_tpu.scene.scene import parse_smm as jax_parse_smm
from gvr_tpu_torch import cli
from gvr_tpu_torch.cameras import OrthographicCamera, PinholeCamera
from gvr_tpu_torch.config import RenderConfig, Solver
from gvr_tpu_torch.integrators import multiscatter as tms
from gvr_tpu_torch.integrators.multiscatter import (render_multiscatter,
                                                    render_path, tile_ids)
from gvr_tpu_torch.io.ppm import quantize, read_ppm
from gvr_tpu_torch.kernels import wavefront as twf
from gvr_tpu_torch.kernels.megatrace import INV_4PI, strat_n, strat_uv
from gvr_tpu_torch.kernels.rng import BOUNCE_DRAWS, wave_uniforms
from gvr_tpu_torch.ops.sampling import dir_from_xi
from gvr_tpu_torch.scene.scene import parse_gmm
from gvr_tpu_torch.testing import (image_agreement, random_lanes,
                                   roulette_edges)

SCENE = random_gaussian_scene(24, seed=7, diameter=(0.2, 0.6),
                              density=(0.5, 2.0))


@pytest.mark.parametrize("camera", ["pinhole", "orthographic"])
def test_render_matches_jax(camera):
    if camera == "pinhole":
        jcam = JPinhole.create([0, 1, 6], [0, 1, 0], 0.25 * math.pi)
        tcam = PinholeCamera.create([0, 1, 6], [0, 1, 0], 0.25 * math.pi)
    else:
        jcam = JOrtho.create([0, 1, 6], [0, 1, 0])
        tcam = OrthographicCamera.create([0, 1, 6], [0, 1, 0])
    want = jax_render(jax_parse_gmm(SCENE), jcam,
                      JConfig(width=16, height=16, spp=9))
    got = render_multiscatter(parse_gmm(SCENE), tcam,
                              RenderConfig(width=16, height=16, spp=9),
                              device="cpu")
    assert got.shape == (16, 16, 3) and got.dtype == np.float32
    assert np.isfinite(got).all() and got.std() > 0
    np.testing.assert_allclose(got, want, atol=1e-4)


def test_render_deterministic_same_seed():
    """JAX's test_multiscatter_deterministic_same_seed: two renders of
    one seed are the same bits."""
    tcam = PinholeCamera.create([0, 1, 6], [0, 1, 0], 0.25 * math.pi)
    cfg = RenderConfig(width=16, height=16, spp=8)
    a = render_multiscatter(parse_gmm(SCENE), tcam, cfg, device="cpu")
    b = render_multiscatter(parse_gmm(SCENE), tcam, cfg, device="cpu")
    np.testing.assert_array_equal(a, b)


def test_render_chunk_invariance():
    """JAX's test_multiscatter_chunk_invariance at its spp 8: ray_chunk 64
    against 65,536, the same bits (JAX's bar is atol 1e-6), and the image
    within image_agreement's bars of JAX's (one path of this scene flips
    a threshold test against JAX's and moves one pixel by 1.4e-4)."""
    jcam = JPinhole.create([0, 1, 6], [0, 1, 0], 0.25 * math.pi)
    tcam = PinholeCamera.create([0, 1, 6], [0, 1, 0], 0.25 * math.pi)
    want = jax_render(jax_parse_gmm(SCENE), jcam,
                      JConfig(width=16, height=16, spp=8))
    cfg = RenderConfig(width=16, height=16, spp=8)
    a, b = (render_multiscatter(parse_gmm(SCENE), tcam,
                                cfg.replace(ray_chunk=chunk), device="cpu")
            for chunk in (64, 1 << 16))
    np.testing.assert_array_equal(a, b)
    res = image_agreement(a, np.asarray(want), 8)
    assert res["ok"], res


@pytest.mark.parametrize("w,h,tile", [
    (1024, 1024, (16, 8)), (512, 512, (16, 8)), (256, 256, (16, 8)),
    (17, 9, (16, 8)), (100, 37, (16, 8)), (15, 7, (16, 8)),
    (33, 130, (16, 8)), (640, 360, (16, 8)), (1, 1, (16, 8)),
    (1, 300, (16, 8)), (300, 1, (16, 8)), (64, 64, (8, 4))])
def test_tile_ids_matches_tile_order(w, h, tile):
    """The order made on the device is the JAX package's sorted one,
    partial tiles on the right and bottom included."""
    tw, th = tile
    got = tile_ids(w, h, "cpu", tw=tw, th=th)
    assert got.dtype == torch.int32 and got.shape == (w * h,)
    assert np.array_equal(got.numpy(), jax_tile_order(w, h, tw, th))


@functools.cache
def _mixtures(n: int):
    """(the JAX package's, the port's) parse of random_gaussian_scene(n,
    seed=0)'s mixture."""
    text = random_gaussian_scene(n, seed=0)
    return jax_parse_gmm(text).medium, parse_gmm(text).medium


@pytest.mark.parametrize("solver", [Solver.ANALYTIC_NEWTON, Solver.BISECTION],
                         ids=["kernel", "bisection"])
@pytest.mark.parametrize("wavefront", ["mega", "step"])
@pytest.mark.parametrize("engine", ["auto", "dense", "grid"])
@pytest.mark.parametrize("n", [250, 2100, 2500])
def test_render_path_follows_jax(n, engine, wavefront, solver):
    """render_path as the JAX package picks the path on its accelerator
    (pallas='interpret'): engine_for's grid; else its XLA branch where
    the kernels are off (a solver they do not implement); else the kernel
    path of its wavefront_pixels (gvr_tpu/integrators/multiscatter.py:
    488-503).  Where the JAX package refuses the configuration, the port
    refuses it too."""
    jm, tm = _mixtures(n)
    jcfg = JConfig(engine=engine, wavefront=wavefront,
                   solver=JSolver(solver.value), pallas="interpret")
    cfg = RenderConfig(engine=engine, wavefront=wavefront, solver=solver)
    try:
        jax_engine = jms.engine_for(jcfg, jm)[0]
    except ValueError:
        with pytest.raises(ValueError):
            render_path(cfg, tm)
        return
    if jax_engine == "grid":
        want = "grid"
    elif not jms._pallas_enabled(jcfg):
        want = "xla"
    elif wavefront == "mega" and mega_supported_n(n):
        want = "mega"
    else:
        want = "step" if pallas_supported_n(n) else "big"
    assert render_path(cfg, tm) == want


# path: (Gaussians, RenderConfig's keys) that take it
PATH_CASES = {"mega": (24, {}), "step": (24, dict(wavefront="step")),
              "big": (2100, dict(engine="dense")),
              "xla": (24, dict(solver=Solver.BISECTION)),
              "grid": (24, dict(engine="grid"))}


@pytest.mark.parametrize("path", sorted(PATH_CASES))
def test_render_is_its_paths_entry(path):
    """render_multiscatter through each path on the CPU (the plain
    versions), 16x8 spp 2 in one chunk: the same bits as the path's own
    entry called once on every pixel in tile order, and stats holding the
    engine ('grid' on the grid, else 'dense'), the kernel (the path), and
    the iterations and bounce evaluations the entry reported."""
    n, kw = PATH_CASES[path]
    sc = parse_gmm(random_gaussian_scene(n, seed=7, diameter=(0.2, 0.6),
                                         density=(0.5, 2.0)))
    cam = PinholeCamera.create([0, 1, 6], [0, 1, 0], 0.25 * math.pi)
    cfg = RenderConfig(width=16, height=8, spp=2, **kw)
    stats = {}
    got = render_multiscatter(sc, cam, cfg, device="cpu", stats=stats)
    assert render_path(cfg, sc.medium) == path and stats["chunks"] == 1
    engine, _, entry, find = tms._PATHS[path]
    run = entry(sc, cam, cfg, "cpu", find(sc.medium))
    ids, st = tile_ids(16, 8, "cpu"), {}
    img = torch.zeros((128, 3))
    img[ids] = run(ids, st)
    assert got.std() > 0
    np.testing.assert_array_equal(got, img.numpy().reshape(8, 16, 3))
    assert engine == ("grid" if path == "grid" else "dense")
    assert (stats["engine"], stats["kernel"]) == (engine, path)
    assert stats["bounce_evals"] == int(st["bounce_evals"]) > 0
    assert stats["iterations"] == st.get("iterations", 0)
    assert (stats["iterations"] > 0) == (path != "mega")


def test_render_same_with_sorted_order(monkeypatch):
    """A render whose chunks take the JAX package's sorted numpy order is
    the same bits: partial tiles and four chunks of at most 256 pixels,
    every pixel once."""
    tcam = PinholeCamera.create([0, 1, 6], [0, 1, 0], 0.25 * math.pi)
    cfg = RenderConfig(width=40, height=21, spp=2, ray_chunk=256)
    stats = {}
    got = render_multiscatter(parse_gmm(SCENE), tcam, cfg, device="cpu",
                              stats=stats)
    assert stats["chunks"] == 4
    monkeypatch.setattr(tms, "tile_ids", lambda w, h, device: torch.from_numpy(
        jax_tile_order(w, h)).to(device))
    want = render_multiscatter(parse_gmm(SCENE), tcam, cfg, device="cpu")
    assert got.std() > 0
    np.testing.assert_array_equal(got, want)


def _eager_iteration(st: dict, live, cfg, camera, env, bounce_fn,
                     edges=None):
    """One iteration of the dense wavefront's loop over the lane state
    ``st`` (ids, o, d, thr, acc, alive, sample, bounce), written out in
    eager PyTorch as one straight line: the reference of the glue in
    kernels/wavefront.py.  ``bounce_fn(o, d, xi [n, 5], xi_solve [n])``
    traces the live lanes; ``edges(thr, bounce, u)``, if given, replaces
    the live lanes' roulette draws.  Returns the next live read's mask."""
    ids, b, dev = st["ids"], st["ids"].shape[0], st["ids"].device
    w, h, spp = cfg.width, cfg.height, cfg.spp
    o, d, thr, acc = st["o"], st["d"], st["thr"], st["acc"]
    alive, sample, bounce = st["alive"], st["sample"], st["bounce"]
    regen = ~alive & (sample < spp)
    bounce = torch.where(regen, 0, bounce)
    sample = torch.where(regen, sample + 1, sample)
    s_cur = torch.clamp(sample, min=1) - 1
    jit, xi = wave_uniforms(ids, s_cur, bounce, cfg.seed).split(
        [2, BOUNCE_DRAWS])
    u, v = strat_uv(ids % w, ids // w, s_cur, strat_n(spp), w, h, jit[0],
                    jit[1])
    o_n, d_n = camera.sample_ray(torch.stack([u, v], dim=-1))
    o = torch.where(regen[:, None], o_n, o)
    d = torch.where(regen[:, None], d_n, d)
    thr = torch.where(regen[:, None], 1.0, thr)
    alive = alive | regen
    if edges is not None:
        xi = xi.clone()
        xi[5, live] = edges(thr[live], bounce[live], xi[5, live])
    res = bounce_fn(o[live], d[live], xi[:5, live].T, xi[8, live])
    w_ne = res[4]
    t_sc, scattered, albedo, li = (
        torch.zeros((b,) + r.shape[1:], dtype=r.dtype, device=dev)
        .index_copy_(0, live, r) for r in res[:4])
    acc = acc + torch.where((alive & ~scattered)[:, None], thr * env, 0.0)
    alive_n = alive & scattered
    pos = o + t_sc[:, None] * d
    acc = acc + torch.where(
        alive_n[:, None], thr * (albedo * INV_4PI * w_ne)[:, None] * li, 0.0)
    thr_n, killed = twf.roulette(cfg, thr, albedo, bounce, xi[5])
    alive = alive_n & ~killed & (bounce + 1 < cfg.max_bounces)
    o = torch.where(alive[:, None], pos, o)
    d = torch.where(alive[:, None], dir_from_xi(xi[6:8].T), d)
    thr = torch.where(alive[:, None], thr_n, thr)
    bounce = bounce + 1
    st.update(o=o, d=d, thr=thr, acc=acc, alive=alive, sample=sample,
              bounce=bounce, inputs=(o[live], d[live], xi[:5, live].T,
                                     xi[5:, live]))
    return alive | (sample < spp)


def _eager_wavefront(scene, camera, cfg, ids, bounce_fn, stats):
    """``multiscatter._wavefront`` as the straight-line eager loop
    (``_eager_iteration``)."""
    st = {k: getattr(twf.lanes(ids, camera), k)
          for k in ("ids", "o", "d", "thr", "acc", "alive", "sample",
                    "bounce")}
    live = torch.nonzero(st["alive"] | (st["sample"] < cfg.spp)).squeeze(1)
    it, cap = 0, cfg.spp * cfg.max_bounces + cfg.max_bounces
    while live.numel():
        want = _eager_iteration(st, live, cfg, camera, scene.env_color,
                                bounce_fn)
        it += 1
        if it == cap:
            break
        live = torch.nonzero(want).squeeze(1)
    if stats is not None:
        stats.update(iterations=it, bounce_evals=0)
    return st["acc"] / cfg.spp


@pytest.mark.parametrize("camera", ["pinhole", "orthographic"])
@pytest.mark.parametrize("seed", [4, 5])
def test_wave_glue_matches_the_eager_loop(camera, seed):
    """kernels/wavefront's plain glue (wave_pre_reference, then
    wave_post_reference) against one eager iteration of the loop, bit for
    bit, on 4,096 random lanes (testing.random_lanes: dead, finished and
    live lanes, regeneration at the last sample, bounce max_bounces - 1,
    roulette draws at and one ulp above the survival probability): the
    bounce's inputs, every lane's state and the next live read's mask."""
    cam = (PinholeCamera.create([0, 1, 6], [0, 1, 0], 0.25 * math.pi)
           if camera == "pinhole"
           else OrthographicCamera.create([0, 1, 6], [0, 1, 0]))
    cfg = RenderConfig(width=96, height=75, spp=9, max_bounces=6,
                       min_scatter=1, rr_tail_after=3, seed=2**31 + seed)
    lanes, live, res, edges = random_lanes(cfg, cam, 4096, "cpu", seed)
    env = torch.tensor([0.3, 0.5, 0.9])
    st = {k: getattr(lanes, k) for k in ("ids", "o", "d", "thr", "acc",
                                         "alive", "sample", "bounce")}
    seen = []

    def bounce_fn(o, d, xi, xi_solve):
        seen.append((o, d, xi, xi_solve))
        return res + (4.0,)

    want = _eager_iteration(st, live, cfg, cam, env, bounce_fn,
                            lambda thr, bounce, u: roulette_edges(
                                cfg, thr, res[2], bounce, u))
    o, d, xi, xr = twf.wave_pre_reference(lanes, live, cfg)
    for g, w in zip((o, d, xi, xr[-1]), seen[0]):
        assert torch.equal(g, w)
    xr[0] = edges(lanes, xr[0])
    assert torch.equal(xr, st["inputs"][3])
    got = twf.wave_post_reference(lanes, live, xr, res, 4.0, env, cfg)
    assert torch.equal(got, want)
    for k in ("o", "d", "thr", "acc", "alive", "sample", "bounce"):
        assert torch.equal(getattr(lanes, k), st[k]), k
    assert lanes.alive.any() and not lanes.alive.all()


@pytest.mark.parametrize("engine", ["big", "step", "xla"])
def test_wavefront_image_same_as_the_eager_loop(monkeypatch, engine):
    """render_multiscatter at 24x16 spp 4 in two chunks through the
    big-N (K4/K5's plain versions), step (K2's) and XLA engines: the same
    bits as through the straight-line eager loop (_eager_wavefront), which
    the tests against the JAX package hold (test_torch_big,
    test_torch_step, test_torch_integrators)."""
    n, kw = {"big": (2100, dict(engine="dense")),
             "step": (24, dict(wavefront="step")),
             "xla": (24, dict(solver=Solver.BISECTION))}[engine]
    text = random_gaussian_scene(n, seed=7, diameter=(0.2, 0.6),
                                 density=(0.5, 2.0))
    tcam = PinholeCamera.create([0, 1, 6], [0, 1, 0], 0.25 * math.pi)
    cfg = RenderConfig(width=24, height=16, spp=4, max_bounces=8,
                       ray_chunk=128, **kw)
    stats = {}
    got = render_multiscatter(parse_gmm(text), tcam, cfg, device="cpu",
                              stats=stats)
    assert (stats["kernel"], stats["chunks"]) == (engine, 2)
    monkeypatch.setattr(tms, "_wavefront", _eager_wavefront)
    want = render_multiscatter(parse_gmm(text), tcam, cfg, device="cpu")
    assert got.std() > 0
    np.testing.assert_array_equal(got, want)


def test_cli_render_writes_ppm(tmp_path, capsys):
    scene = tmp_path / "scene.txt"
    scene.write_text(SCENE)
    out = tmp_path / "out.ppm"
    cli.main(["render", str(scene), "-o", str(out), "--width", "16",
              "--height", "16", "--spp", "4", "--device", "cpu"])
    img = read_ppm(str(out))
    assert img.shape == (16, 16, 3) and img.std() > 0
    assert "wrote" in capsys.readouterr().out
    # the ray marcher renders a Gaussian scene, and a sphere scene through
    # the sphere marcher, as the JAX package's CLI routes it
    cli.main(["render", str(scene), "-o", str(out), "--width", "8",
              "--height", "8", "--integrator", "raymarch", "--step-size",
              "0.05", "--env-samples", "2", "--device", "cpu"])
    assert read_ppm(str(out)).shape == (8, 8, 3)
    spheres = tmp_path / "spheres.txt"
    spheres.write_text("s 0 1 0  1.0  0.8 0.0\n")
    cli.main(["render", str(spheres), "-o", str(out), "--width", "8",
              "--height", "8", "--integrator", "raymarch", "--step-size",
              "0.05", "--env-samples", "2", "--device", "cpu"])
    want = render_raymarch_spheres(
        jax_parse_smm("s 0 1 0  1.0  0.8 0.0\n"),
        JPinhole.create([0, 1, 6], [0, 1, 0], math.radians(45.0)),
        JConfig(width=8, height=8, step_size=0.05, env_samples=2))
    # the PPM's truncation to 1/255: a float difference at rtol 1e-4 moves
    # a byte by at most one level
    got = read_ppm(str(out))
    assert np.abs(got - quantize(np.asarray(want)) / 255.0).max() \
        <= 1.0 / 255.0 + 1e-7
    assert got.std() > 0
