"""The port's parallel layer on the CPU against the one-process port and
the JAX package: data parallelism over rays (``sharded_render_fn``,
``render_multiscatter`` over a mesh, ``sharded_value_and_grad``, the fit
and the CLI in a job), tensor parallelism over the Gaussians
(``ops/gaxis`` under a ``gauss`` group, ``render_rays_tp``,
``render_multiscatter_tp``, ``fit_value_and_grad_tp`` and an Adam
trajectory), and the tooling (``RenderStats``, ``device_trace``, ``cli
render --trace``, ``bench_series``).

One job of 8 gloo ranks (``parallel.launch.spawn`` of
``parallel.checks.cpu_suite``, a minute's timeout on every collective)
runs every parallel case once, in a thread started with the module, while
the parent computes the JAX package's references on the conftest's
8-device CPU mesh.  The data-parallel cases mirror tests/test_sharding.py
and the tensor-parallel ones tests/test_gauss_sharded.py, at their bars;
the JAX side is the reference those tests hold their sharded results
against (the one-device estimator, or JAX's own sharded render where it
is cheap), since compiling JAX's shard_map'd gradients takes minutes.
The data-parallel images must equal the one-process port's bit for bit.
"""

import concurrent.futures
import functools
import json
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import _torch_common  # noqa: F401  (sets torch threads)
from _torch_common import scene_arrays
from gvr_tpu.cameras import PinholeCamera as JPinhole
from gvr_tpu.config import RenderConfig as JConfig
from gvr_tpu.config import Solver as JSolver
from gvr_tpu.integrators import multiscatter as jms
from gvr_tpu.inverse import fit as jfit
from gvr_tpu.ops import transmittance as jtrans
from gvr_tpu.parallel import __all__ as JAX_PARALLEL_ALL
from gvr_tpu.parallel.gauss_sharded import pad_mixture as jax_pad_mixture
from gvr_tpu.parallel.sharding import make_mesh as jax_make_mesh
from gvr_tpu.parallel.sharding import sharded_render_fn as jax_sharded_fn
from gvr_tpu.parallel.sharding import shard_rays as jax_shard_rays
from gvr_tpu.scene.generators import random_gaussian_scene
from gvr_tpu.scene.scene import parse_gmm as jax_parse_gmm
from gvr_tpu.utils.profiling import RenderStats as JRenderStats
from gvr_tpu.utils.profiling import Span as JSpan
from gvr_tpu.utils.profiling import path_statistics as jax_path_statistics
from gvr_tpu_torch import bench_series, cli, parallel
from gvr_tpu_torch.config import RenderConfig
from gvr_tpu_torch.integrators.multiscatter import (
    mc_camera_rays, multiscatter_radiance, render_multiscatter, tile_ids,
    wavefront_pixels_xla)
from gvr_tpu_torch.inverse.fit import fit_loss
from gvr_tpu_torch.io.ppm import write_ppm
from gvr_tpu_torch.ops import gaxis
from gvr_tpu_torch.ops.transmittance import compact_candidates, tau_coeffs
from gvr_tpu_torch.parallel import checks
from gvr_tpu_torch.parallel.gauss_sharded import pad_mixture
from gvr_tpu_torch.parallel.launch import spawn
from gvr_tpu_torch.parallel.sharding import (grid_mesh, make_mesh,
                                             shard_rays)
from gvr_tpu_torch.scene.convert import params_from_numpy, scene_from_numpy
from gvr_tpu_torch.scene.scene import parse_gmm
from gvr_tpu_torch.testing import TP_BARS, tp_agreement
from gvr_tpu_torch.utils.profiling import (TRACE_FILE, RenderStats, Span,
                                           device_trace)

# tests/test_sharding.py's scene and grid scene; tests/test_gauss_sharded
# .py's counts and seeds, at test_inverse.py's diameters 0.2-0.7: at the
# generator's default ones the 16^2 rays cross at most one of the 40 or
# 37 Gaussians (3 and 8 rays hit), so no sum over shards changes order,
# and the 8x8 rays miss all 8, so the fit's gradient is 0; here rays
# cross up to 17, 15 and 3
FAT = dict(diameter=(0.2, 0.7))
SCENE = ("l 0 4 0  8 8 8\n"
         "g 0.1 1.0 0.2  0.08 0.01 0  0.07 0 0.09  1.5 0.7\n")
TEXTS = {"scene1": SCENE,
         "scene24": random_gaussian_scene(24, seed=11, diameter=(0.1, 0.6)),
         "scene37": random_gaussian_scene(37, seed=11, **FAT),
         "scene40": random_gaussian_scene(40, seed=7, **FAT),
         "scene8": random_gaussian_scene(8, seed=3, **FAT)}
JCAM = JPinhole.create([0, 1, 6], [0, 1, 0], 0.25 * math.pi)
RANKS = 8
# a DP render's JAX reference: the same image ('awkward' is 'mega' with
# another chunk; 'step' is 'mega' through the step wavefront, and JAX on
# the CPU renders both through its XLA branch)
JAX_DP = {"awkward": "mega", "step": "mega"}
# the CLI in the job: 8x8 renders; a 2-iteration fit of 64-pixel batches
CLI_RENDER = ["--width", "8", "--height", "8", "--spp", "2"]
CLI_FIT = ["--iters", "2", "--batch-pixels", "64", "--bounces", "2",
           "--spp", "2", "--final-spp", "2", "--save-every", "1",
           "--snapshots"]


@functools.cache
def jax_scene(key):
    return jax_parse_gmm(TEXTS[key])


def port(key):
    """The port's scene from JAX's parsed arrays (eigh's signs differ
    between the packages; both get the same arrays)."""
    return scene_from_numpy(scene_arrays(jax_scene(key)))


def _jconfig(kw):
    kw = dict(kw)
    if "solver" in kw:
        kw["solver"] = JSolver(kw["solver"].value)
    return JConfig(**kw)


@pytest.fixture(scope="module")
def cli_files(tmp_path_factory):
    d = tmp_path_factory.mktemp("cli")
    scene = d / "scene.txt"
    scene.write_text(SCENE)
    target = d / "target.ppm"
    write_ppm(str(target), render_multiscatter(
        parse_gmm(SCENE), checks.camera(), RenderConfig(
            width=8, height=8, spp=16), device="cpu"))
    return dict(dir=str(d), scene=str(scene), target=str(target),
                render=CLI_RENDER, fit=CLI_FIT)


@pytest.fixture(scope="module")
def suite(cli_files):
    """A future of the 8 ranks' results, started with the module; the
    JAX references are computed while the ranks run."""
    inp = {k: scene_arrays(jax_scene(k)) for k in TEXTS}
    inp["params1"] = np.asarray(jax_scene("scene1").medium.pack_parameters())
    inp["params8"] = np.asarray(jax_scene("scene8").medium.pack_parameters())
    inp["cli"] = cli_files
    pool = concurrent.futures.ThreadPoolExecutor(1)
    fut = pool.submit(spawn, checks.cpu_suite, RANKS, inp, timeout=60.0,
                      deadline=240.0)
    try:
        for name in ("render_fn", "mega", "xla"):
            jax_dp(name)
        jax_dp_grad()
        for key, kw in (("scene40", checks.TP_RAYS),
                        ("scene37", checks.TP_RAYS),
                        ("scene40", checks.TP_UNIFORM)):
            jax_radiance(key, tuple(kw.items()))
        jax_fit_trajectory()
        yield fut
    finally:
        pool.shutdown(wait=True)


def result(suite, case, rank=0):
    res = suite.result()[rank][case]
    assert not (isinstance(res, dict) and "error" in res), res
    return res


def _assert_radiance_close(got, want):
    """tests/test_gauss_sharded.py's bars (testing.TP_BARS): every element
    within rtol / atol 2e-3, the means within 1e-5, the 99th percentile
    of |diff| below 1e-4."""
    res = tp_agreement(got, want)
    assert res["ok"], (res, TP_BARS)


# ---- the JAX package's references --------------------------------------

@functools.cache
def jax_pixel_rays(w, h):
    return jfit._pixel_rays(JCAM, w, h, jnp.arange(w * h, dtype=jnp.int32))


@functools.cache
def jax_dp(name):
    """JAX's data-parallel render of a case on the conftest's 8 devices:
    sharded_render_fn, or render_multiscatter (which shards every chunk
    over all devices)."""
    if name == "render_fn":
        cfg = JConfig(width=16, height=16, spp=1)
        fn = jax_sharded_fn(
            lambda sc, o, d, i: jms.multiscatter_radiance(sc, o, d, i, cfg),
            jax_make_mesh(jax.devices()[:8]))
        return np.asarray(jax.jit(fn)(jax_scene("scene1"),
                                      *jax_pixel_rays(16, 16)))
    key, kw = checks.DP_RENDERS[name]
    return np.asarray(jms.render_multiscatter(jax_scene(key), JCAM,
                                              _jconfig(kw)))


@functools.cache
def jax_dp_grad():
    """JAX's value_and_grad of fit_loss on the 16^2 rays of
    test_sharding.py's scene (target 0.3, 2 bounces)."""
    o, d, ids = jax_pixel_rays(16, 16)
    sc = jax_scene("scene1")
    v, g = jax.jit(jax.value_and_grad(
        lambda q: jfit.fit_loss(q, sc, o, d, ids,
                                jnp.full((256, 3), 0.3, jnp.float32),
                                n_bounces=2)))(sc.medium.pack_parameters())
    return float(v), np.asarray(g)


@functools.cache
def jax_radiance(key, kw):
    """JAX's one-device multiscatter_radiance of 16^2 pixel rays."""
    cfg = _jconfig(dict(kw))
    o, d, ids = jax_pixel_rays(16, 16)
    return np.asarray(jax.jit(
        lambda sc, o, d, i: jms.multiscatter_radiance(sc, o, d, i, cfg))(
            jax_scene(key), o, d, ids))


@functools.cache
def jax_fit_trajectory():
    """JAX's dense fit_loss value and gradient on the 8-Gaussian scene's
    8x8 rays (target 0.4, 2 bounces) and its 3 Adam steps at lr 5e-2, as
    tests/test_gauss_sharded.py computes them: [(loss, grad)], params."""
    sc = jax_scene("scene8")
    o, d, ids = jax_pixel_rays(8, 8)
    target = jnp.full((64, 3), 0.4, jnp.float32)
    vg = jax.jit(lambda p, seed: jax.value_and_grad(jfit.fit_loss)(
        p, sc, o, d, ids, target, n_bounces=2, seed=seed))
    opt = optax.adam(checks.ADAM_LR)
    p = sc.medium.pack_parameters()
    st = opt.init(p)
    steps = []
    for it in range(checks.ADAM_STEPS):
        v, g = vg(p, jnp.int32(it))
        steps.append((float(v), np.asarray(g)))
        up, st = opt.update(g, st, p)
        p = optax.apply_updates(p, up)
    return steps, np.asarray(p)


# ---- checks that spawn nothing ------------------------------------------

def test_parallel_exports_match_jax():
    assert parallel.__all__ == list(JAX_PARALLEL_ALL)
    for n in (1, 7, 8, 300):
        for k in (1, 2, 3, 8):
            assert shard_rays(n, k) == jax_shard_rays(n, k)


def test_meshes_outside_a_job():
    """Without a process group the mesh is the one process; a larger one
    raises instead of quietly dropping to one rank."""
    mesh = make_mesh()
    assert mesh.shape == {"rays": 1} and mesh.size == 1
    assert mesh.group("rays") is None and mesh.index("rays") == 0
    with pytest.raises(RuntimeError, match="initialized process group"):
        parallel.make_mesh_2d(2, 1)
    assert grid_mesh(("rays", "gauss"), (1, 1)).shape == {"rays": 1,
                                                         "gauss": 1}


def test_candidate_k_refused_under_an_active_axis():
    sc = port("scene40")
    rg = tau_coeffs(sc.medium, torch.zeros((4, 3)), torch.ones((4, 3)))
    assert gaxis.active() is None
    with gaxis.gaussian_axis(object()):
        with pytest.raises(ValueError, match="not tensor-parallel"):
            compact_candidates(rg, sc.medium.albedo, 4)
    assert gaxis.active() is None


def test_pad_mixture_rows_are_inert():
    """37 Gaussians pad to 40 on a 4-way axis, as in JAX: the padded rows
    are JAX's (mean 1e9, unit covariance, zero density and albedo) and
    hit no ray."""
    sc = port("scene37")
    padded = pad_mixture(sc.medium, 4)
    want = jax_pad_mixture(jax_scene("scene37").medium, 4)
    assert padded.n == want.n == 40
    for f in ("mean", "cov", "density", "albedo", "inv_cov", "norm"):
        np.testing.assert_allclose(getattr(padded, f)[37:].numpy(),
                                   np.asarray(getattr(want, f))[37:],
                                   rtol=1e-6)
    assert pad_mixture(padded, 4) is padded
    o, d, _ = checks.pixel_rays(16, 16)
    assert not tau_coeffs(padded, o, d).hit[:, 37:].any()


def test_render_stats_report_and_json_match_jax():
    spans = [("chunk", 0.25, dict(pixels=256, paths=512, engine="dense",
                                  shards=8)),
             ("render_multiscatter", 1.5, dict(engine="dense", n=24,
                                               mpaths_per_s=3.25)),
             ("bare", 0.0, {})]
    ours, theirs = RenderStats(), JRenderStats()
    for name, sec, extra in spans:
        ours.add(name, sec, **extra)
        theirs.add(name, sec, **extra)
    with ours.span("timed", k=1):
        pass
    theirs.spans.append(JSpan("timed", ours.spans[-1].seconds, dict(k=1)))
    assert ours.report() == theirs.report()
    assert isinstance(ours.spans[0], Span) and isinstance(ours, dict)


def test_render_multiscatter_fills_render_stats():
    """A RenderStats gets the render loop's spans, JAX's chunk and
    render_multiscatter among them, in the order they end, and, as a
    dict, the summary a plain dict gets."""
    stats, plain = RenderStats(), {}
    cfg = RenderConfig(width=16, height=16, spp=2, ray_chunk=256)
    for st in (stats, plain):
        render_multiscatter(port("scene1"), checks.camera(), cfg,
                            device="cpu", stats=st)
    assert [s.name for s in stats.spans] == [
        "render.prepare", "chunk", "render.readback", "render_multiscatter"]
    assert stats.spans[1].extra == dict(pixels=256, paths=512,
                                        engine="dense", kernel="mega",
                                        shards=1)
    assert stats.spans[3].extra["paths"] == 512
    assert stats.counters == {}
    assert set(stats) == set(plain) and stats["shards"] == 1
    assert {k: stats[k] for k in ("engine", "kernel", "paths", "chunks")} \
        == {k: plain[k] for k in ("engine", "kernel", "paths", "chunks")}


def test_device_trace_writes_and_raises(tmp_path):
    """The trace is a Chrome trace of the work inside; where the profiler
    cannot start (one is running) or the trace cannot be written,
    device_trace raises; no log_dir, no trace."""
    with device_trace(str(tmp_path / "t")):
        torch.ones(64, 64).matmul(torch.ones(64, 64))
    trace = json.loads((tmp_path / "t" / TRACE_FILE).read_text())
    assert any("mm" in e.get("name", "") for e in trace["traceEvents"])
    with pytest.raises(RuntimeError, match="profiler is running"):
        with device_trace(str(tmp_path / "a")):
            with device_trace(str(tmp_path / "b")):
                pass
    (tmp_path / "file").write_text("")
    with pytest.raises(OSError):
        with device_trace(str(tmp_path / "file" / "x")):
            pass
    with device_trace(None):
        pass


def test_cli_render_trace_and_stats(tmp_path, capsys):
    scene = tmp_path / "s.txt"
    scene.write_text(TEXTS["scene24"])
    stats = cli.main(["render", str(scene), "-o", str(tmp_path / "o.ppm"),
                      "--width", "8", "--height", "8", "--spp", "2",
                      "--stats", "--trace", str(tmp_path / "tr"), "--device",
                      "cpu"])
    out = capsys.readouterr().out
    trace = json.loads((tmp_path / "tr" / TRACE_FILE).read_text())
    spans = ["render.prepare", "chunk", "render.readback",
             "render_multiscatter"]
    traced = {e.get("name") for e in trace["traceEvents"]}
    assert set(spans) <= traced and "aten::mul" in traced
    assert "[gvr] chunk:" in out and "[gvr] render_multiscatter:" in out
    assert stats["kernel"] == "mega"
    assert [s.name for s in stats.spans] == spans
    cli.main(["render", str(scene), "-o", str(tmp_path / "h.ppm"),
              "--width", "8", "--height", "8", "--integrator", "hitmask",
              "--trace", str(tmp_path / "tr2"), "--device", "cpu"])
    assert "only instrumented for --integrator multiscatter" in \
        capsys.readouterr().out
    assert not (tmp_path / "tr2").exists()


@pytest.mark.parametrize("engine", ["dense", "grid"])
def test_bench_series_row_format(engine, tmp_path, capsys, monkeypatch):
    """A row of a tiny generated scene holds scripts/bench_series.py's
    keys, the engine JAX picks and JAX's rays per path; main reads the
    fixtures it finds and prints the series."""
    text = random_gaussian_scene(50, seed=0)
    cfg = RenderConfig(width=8, height=8, spp=1, engine=engine)
    row = bench_series.bench_row("t", parse_gmm(text), checks.camera(), cfg,
                                 "cpu")
    keys = {"scene", "gaussians", "rays_per_path", "seconds",
            "mrays_per_sec", "engine"}
    if engine == "grid":
        keys |= {"grid_side", "slices", "s_cap"}
    assert set(row) == keys and row["gaussians"] == 50
    jcfg = JConfig(width=8, height=8, spp=1, engine=engine,
                   pallas="interpret")
    assert row["engine"] == jms.engine_for(jcfg, jax_parse_gmm(text)
                                           .medium)[0]
    want = jax_path_statistics(jax_parse_gmm(text), JCAM, jcfg)
    assert row["rays_per_path"] == round(want["rays_per_path"], 2)
    if engine == "grid":
        return
    (tmp_path / "50_random.txt").write_text(text)
    monkeypatch.setenv("BENCH_40K", "0")
    rows = bench_series.main(["--size", "8", "--spp", "1", "--device",
                              "cpu", "--fixtures", str(tmp_path)])
    lines = capsys.readouterr().out.strip().splitlines()
    assert [r["scene"] for r in rows] == ["50_random.txt"]
    assert json.loads(lines[-1]) == {"series": rows}


# ---- data parallel over rays ---------------------------------------------

@pytest.mark.parametrize("k", checks.DP_SHARDS)
def test_sharded_render_matches_single_device(suite, k):
    """sharded_render_fn over k ranks: the one-process radiance bit for
    bit, and JAX's sharded_render_fn over 8 devices within
    test_sharding.py's atol 2e-6."""
    want = jax_dp("render_fn")
    got = result(suite, f"dp_render_fn_{k}")
    o, d, ids = checks.pixel_rays(16, 16)
    one = multiscatter_radiance(port("scene1"), o, d, ids,
                                RenderConfig(width=16, height=16, spp=1))
    assert np.array_equal(got, one.numpy())
    np.testing.assert_allclose(got, want, atol=2e-6)


@pytest.mark.parametrize("k", checks.DP_SHARDS)
def test_shard_last_arg_matches_one_process(suite, k):
    """shard_last_arg around the dense XLA engine's wavefront (scene and
    camera replicated, the tile-ordered ids sharded): every rank returns
    the one-process radiance bit for bit."""
    ids = tile_ids(16, 16, "cpu")
    cfg = RenderConfig(**checks.DP_RENDERS["xla"][1])
    one = wavefront_pixels_xla(port("scene1"), checks.camera(), cfg, ids)
    for rank in range(k):
        assert np.array_equal(result(suite, f"dp_last_arg_{k}", rank),
                              one.numpy())


@pytest.mark.parametrize("name", list(checks.DP_RENDERS))
@pytest.mark.parametrize("k", checks.DP_SHARDS)
def test_production_render_is_shard_invariant(suite, name, k):
    """render_multiscatter over k ranks (each engine; a ray_chunk no shard
    count divides): every rank returns the one-process image bit for bit,
    the chunk padded to whole 256-ray blocks per shard where it is big
    enough.  Against JAX's sharded render the bar is the port's against
    JAX's one-device render (tests/test_torch_multiscatter.py, atol
    1e-4): the two packages round apart by up to 2.5e-6 on a pixel here,
    whether sharded or not, above test_sharding.py's 2e-6 between one
    package's sharded and one-device images, which the bit-for-bit
    equality above replaces.  The grid image is held against JAX's in
    tests/test_torch_grid.py; here against the one process only."""
    key, kw = checks.DP_RENDERS[name]
    one = render_multiscatter(port(key), checks.camera(),
                              RenderConfig(**kw), device="cpu")
    for rank in range(k):
        assert np.array_equal(result(suite, f"dp_{name}_{k}", rank), one)
    st = result(suite, f"dp_{name}_{k}_stats")
    assert st["shards"] == k and st["chunk"] % k == 0
    if st["chunk"] >= 256 * k:
        assert st["chunk"] % (256 * k) == 0
    if name != "grid":
        np.testing.assert_allclose(result(suite, f"dp_{name}_{k}"),
                                   jax_dp(JAX_DP.get(name, name)), atol=1e-4)


@pytest.mark.parametrize("k", checks.DP_GRAD_SHARDS)
def test_sharded_grads_match_unsharded(suite, k):
    """sharded_value_and_grad over k ranks against the one-process
    fit_loss and backward, and JAX's value_and_grad: the loss within rtol
    1e-5, the gradient within rtol 1e-3 / atol 1e-5 (test_sharding.py's
    bars)."""
    loss, grad = result(suite, f"dp_grad_{k}")
    sc = port("scene1")
    p = params_from_numpy(np.asarray(
        jax_scene("scene1").medium.pack_parameters())).requires_grad_(True)
    o, d, ids = checks.pixel_rays(16, 16)
    one = fit_loss(p, sc, o, d, ids, torch.full((256, 3), 0.3), n_bounces=2)
    one.backward()
    for want_v, want_g in ((one.item(), p.grad.numpy()), jax_dp_grad()):
        np.testing.assert_allclose(float(loss), want_v, rtol=1e-5)
        np.testing.assert_allclose(grad, want_g, rtol=1e-3, atol=1e-5)


def test_cli_render_in_a_job_writes_once(suite, cli_files):
    """`cli render` on every rank of the 8-rank job: the render shards
    over all 8, only rank 0 writes, and its PPM is the one-process CLI's
    byte for byte."""
    d = cli_files["dir"]
    for rank in range(RANKS):
        st = result(suite, "cli_render", rank)
        assert st["shards"] == RANKS and st["kernel"] == "mega"
    assert sorted(f for f in os.listdir(d) if f.startswith("render_")) \
        == ["render_r0.ppm"]
    cli.main(["render", cli_files["scene"], "-o", f"{d}/one.ppm",
              "--device", "cpu"] + CLI_RENDER)
    with open(f"{d}/one.ppm", "rb") as a, open(f"{d}/render_r0.ppm",
                                               "rb") as b:
        assert a.read() == b.read()


def test_dp_fit_matches_one_process(suite, cli_files):
    """`cli fit` on every rank of the job (data parallel over 8 ranks,
    snapshots rendered over them): only rank 0 writes, every rank ends
    with the same parameters, and the losses (rtol 1e-4) and final
    parameters (rtol 1e-3 / atol 1e-5) are the one-process fit's."""
    d = cli_files["dir"]
    res = [result(suite, "cli_fit", rank) for rank in range(RANKS)]
    for r in res[1:]:
        np.testing.assert_array_equal(r["params"], res[0]["params"])
    assert sorted(f for f in os.listdir(d) if f.startswith("fit_")) \
        == ["fit_r0"]
    assert {"ckpt.npz", "final.ppm", "iter_0000.ppm", "iter_0001.ppm"} \
        <= set(os.listdir(f"{d}/fit_r0"))
    one = cli.main(["fit", cli_files["scene"], "--target",
                    cli_files["target"], "-o", f"{d}/fit_one", "--device",
                    "cpu"] + CLI_FIT)
    assert [i for i, _ in res[0]["losses"]] == [0, 1]
    np.testing.assert_allclose([v for _, v in res[0]["losses"]],
                               [v for _, v in one["losses"]], rtol=1e-4)
    np.testing.assert_allclose(res[0]["params"], one["params"], rtol=1e-3,
                               atol=1e-5)


# ---- tensor parallel over the Gaussians ----------------------------------

def test_tau_reductions_match_under_gauss_axis(suite):
    """tau_total, tau_up_to(5), sigma_t(5) and far_bound of the 40
    Gaussians over 8 gauss ranks against JAX's one-device values, at
    test_gauss_sharded.py's rtol 3e-5 / atol 1e-6."""
    got = result(suite, "tp_reductions")
    o, d, _ = jax_pixel_rays(16, 16)
    rg = jtrans.tau_coeffs(jax_scene("scene40").medium, o, d)
    t = jnp.full(o.shape[:1], 5.0)
    want = (jtrans.tau_total(rg), jtrans.tau_up_to(rg, t),
            jtrans.sigma_t_at(rg, t), jtrans.far_bound(rg))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, np.asarray(w), rtol=3e-5, atol=1e-6)


@pytest.mark.parametrize("shape", checks.TP_SHAPES,
                         ids=lambda s: f"{s[0]}x{s[1]}")
def test_tp_radiance_matches_dense(suite, shape):
    got = result(suite, f"tp_rays_{shape[0]}x{shape[1]}")
    _assert_radiance_close(got, jax_radiance("scene40",
                                             tuple(checks.TP_RAYS.items())))


def test_tp_padding_inert(suite):
    _assert_radiance_close(result(suite, "tp_pad"),
                           jax_radiance("scene37",
                                        tuple(checks.TP_RAYS.items())))


def test_tp_uniform_solver(suite):
    _assert_radiance_close(result(suite, "tp_uniform"),
                           jax_radiance("scene40",
                                        tuple(checks.TP_UNIFORM.items())))


def test_tp_image_render_matches_sample_loop(suite):
    """render_multiscatter_tp over (2 x 4) against the one-process port's
    and JAX's per-sample loops (mc_camera_rays + multiscatter_radiance)."""
    cfg, jcfg = RenderConfig(**checks.TP_IMAGE), JConfig(**checks.TP_IMAGE)
    ids = torch.arange(144, dtype=torch.int32)
    sc, jsc = port("scene40"), jax_scene("scene40")
    acc = torch.zeros((144, 3))
    jacc = jnp.zeros((144, 3), jnp.float32)
    for si in range(cfg.spp):
        acc = acc + multiscatter_radiance(
            sc, *mc_camera_rays(sc, checks.camera(), cfg, ids, si), cfg,
            sample=si)
        jo, jd, jids = jms.mc_camera_rays(jsc, JCAM, jcfg,
                                          jnp.asarray(ids.numpy()),
                                          jnp.int32(si))
        jacc = jacc + jms.multiscatter_radiance(jsc, jo, jd, jids, jcfg,
                                                sample=jnp.int32(si))
    got = result(suite, "tp_image")
    _assert_radiance_close(got, (acc / cfg.spp).numpy())
    _assert_radiance_close(got, np.asarray(jacc) / cfg.spp)


def test_tp_fit_gradients_match_dense(suite):
    """fit_value_and_grad_tp over (2 x 4), its gradient gathered over the
    gauss axis, against JAX's dense value_and_grad: the loss within 1e-6
    of max(1, |loss|), the gradient within rtol 1e-3 / atol 1e-6."""
    loss, grad = result(suite, "tp_fit")
    want_v, want_g = jax_fit_trajectory()[0][0]
    assert abs(float(loss) - want_v) < 1e-6 * max(1.0, abs(want_v))
    np.testing.assert_allclose(grad, want_g, rtol=1e-3, atol=1e-6)


def test_tp_fit_adam_trajectory_matches_dense(suite):
    """Three Adam steps, each gauss rank stepping its own slice of the
    parameters and of Adam's state, against JAX's dense trajectory with
    optax: losses within rtol 1e-4, parameters within rtol 1e-3 / atol
    1e-5."""
    losses, params = result(suite, "tp_adam")
    steps, want_p = jax_fit_trajectory()
    np.testing.assert_allclose(losses, [v for v, _ in steps], rtol=1e-4)
    np.testing.assert_allclose(params, want_p, rtol=1e-3, atol=1e-5)
    for rank in range(1, RANKS):
        np.testing.assert_array_equal(result(suite, "tp_adam", rank)[1],
                                      params)
