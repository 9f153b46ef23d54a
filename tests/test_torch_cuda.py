"""The CUDA kernels against their plain versions on the card, and the
port on the card: each path through the CLI at the size it serves, the
trace, and the parallel layer on two ranks that share the card.

Every test here needs a CUDA card and skips without one.  The file imports
neither JAX nor gvr_tpu, so on a machine with a card and no JAX it runs as

    python -m pytest tests/test_torch_cuda.py -m gpu --noconftest -q

(--noconftest: tests/conftest.py sets up JAX for the rest of the suite)."""

import json
import math
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from _torch_common import check_bounce, cuda_device, random_rays  # noqa: F401
from gvr_tpu_torch.accel.grid import build_grid, dda_crossings
from gvr_tpu_torch.cameras import OrthographicCamera, PinholeCamera
from gvr_tpu_torch.config import RenderConfig, Solver
from gvr_tpu_torch.integrators.freeflight import render_single_scatter
from gvr_tpu_torch.integrators import multiscatter as tms
from gvr_tpu_torch.integrators.gridscatter import (_nee_select,
                                                   critical_crossing,
                                                   grid_tau_crossings)
from gvr_tpu_torch import cli
from gvr_tpu_torch.integrators.multiscatter import (
    diff_uniforms, multiscatter_radiance_diff, render_multiscatter,
    wavefront_pixels_big)
from gvr_tpu_torch.integrators.raymarch import (render_pure_raymarch,
                                                render_raymarch_gaussians,
                                                render_raymarch_spheres)
from gvr_tpu_torch.integrators.test_hit import render_hit_mask
from gvr_tpu_torch.inverse import fit as tfit
from gvr_tpu_torch.io import gif
from gvr_tpu_torch.io.ppm import read_ppm, write_ppm
from gvr_tpu_torch.kernels import gridtrace as tgt
from gvr_tpu_torch.kernels import megatrace as tmt
from gvr_tpu_torch.kernels import pathtrace as tpt
from gvr_tpu_torch.kernels import pathtrace_big as tpb
from gvr_tpu_torch.kernels import rng as trng
from gvr_tpu_torch.kernels import wavefront as twf
from gvr_tpu_torch.parallel import checks
from gvr_tpu_torch.parallel.launch import spawn
from gvr_tpu_torch.ops import transmittance as tto
from gvr_tpu_torch.scene.convert import (MIXTURE_FIELDS, SCENE_FIELDS,
                                         params_from_numpy, scene_from_numpy)
from gvr_tpu_torch.scene.gaussians import GaussianMixture
from gvr_tpu_torch.scene.generators import (random_gaussian_scene,
                                            random_sphere_scene)
from gvr_tpu_torch.scene.scene import parse_gmm, parse_smm
from gvr_tpu_torch.scene.voxels import VoxelGrid
from gvr_tpu_torch.testing import (BIG_DENSE_BARS, BOUNCE_BARS,
                                   PATH_BOUNCE_BARS, bake_agreement,
                                   bounce_agreement, random_lanes,
                                   big_kernel_vs_plain, big_loops, big_rays,
                                   card_cpu_agreement, chunk_agreement,
                                   gif_structure, image_agreement,
                                   fit_agreement, mega_agreement,
                                   solve_agreement, solve_fd_agreement,
                                   span_tau_agreement, tp_agreement)
from gvr_tpu_torch.utils.profiling import TRACE_FILE, path_statistics

pytestmark = pytest.mark.gpu

ROOT = pathlib.Path(__file__).resolve().parents[1]

# 24 Gaussians under the generator's 3 point lights
SCENE24 = random_gaussian_scene(24, seed=7, diameter=(0.2, 0.6),
                                density=(0.5, 2.0))
MEGA_KW = dict(width=16, height=16, spp=9, max_bounces=6)
# The grid fixture of tests/test_grid.py: fat Gaussians over many cells.
SCENE120 = random_gaussian_scene(120, seed=3, diameter=(0.05, 0.9))


def _cameras(device):
    return (PinholeCamera.create([0, 1, 6], [0, 1, 0], 0.25 * math.pi,
                                 device=device),
            OrthographicCamera.create([0, 1, 6], [0, 1, 0], device=device))


def _mega_args(sc, cam, cfg, ids):
    return (tmt.camera_vector(cam), tpt.pack_table(sc.medium), ids, cfg,
            sc.lights(), sc.env_color, isinstance(cam, PinholeCamera))


def test_uniforms_kernel_matches_plain(cuda_device):
    r = np.random.default_rng(5)
    pid, s, b = (torch.from_numpy(r.integers(0, hi, (512, 128))
                                  .astype(np.int32)).to(cuda_device)
                 for hi in (2**31 - 1, 64, 64))
    for bounce in (b, trng.JITTER_TAG):
        got = trng.planes_uniforms(pid, s, bounce, 9, 2**31 + 5)
        want = trng.planes_uniforms_reference(pid, s, bounce, 9, 2**31 + 5)
        torch.cuda.synchronize()
        assert torch.equal(got, want)


@pytest.mark.parametrize("lanes", [70_001, 255, 1])
def test_wave_uniforms_kernel_matches_plain(cuda_device, lanes):
    """The wavefronts' one K3 launch (jitter pair + nine bounce draws) at
    lane counts that are not a multiple of its 256-thread block, into a
    fresh output and into a given buffer."""
    r = np.random.default_rng(6)
    pid, s, b = (torch.from_numpy(r.integers(0, hi, lanes)
                                  .astype(np.int32)).to(cuda_device)
                 for hi in (2**31 - 1, 1 << 20, 64))
    want = trng.wave_uniforms_reference(pid, s, b, 2**31 + 5)
    got = trng.wave_uniforms(pid, s, b, 2**31 + 5)
    buf = torch.full((11, lanes), -1.0, device=cuda_device)
    assert trng.wave_uniforms(pid, s, b, 2**31 + 5, out=buf) is buf
    torch.cuda.synchronize()
    assert torch.equal(got, want) and torch.equal(buf, want)
    with pytest.raises(ValueError, match="out"):
        trng.wave_uniforms(pid, s, b, 0, out=buf[:10])
    with pytest.raises(ValueError, match="bounce"):
        trng.wave_uniforms(pid, s, b.long(), 0)


@pytest.mark.parametrize("finisher", [False, True])
@pytest.mark.parametrize("n_lights", [0, 3])
def test_bounce_kernel_matches_plain(cuda_device, finisher, n_lights):
    text = random_gaussian_scene(250, seed=0, lights=((
        0.0, 5.0, 0.1, 50.0, 0.0, 0.0), (-3.0, 3.0, 0.3, 0.0, 30.0, 0.0),
        (3.0, 3.0, -0.2, 0.0, 0.0, 30.0))[:n_lights])
    sc = parse_gmm(text, device=cuda_device)
    o, d, xi = (torch.from_numpy(a).to(cuda_device)
                for a in random_rays(65536, seed=1))
    args = (tpt.pack_table(sc.medium), o, d, xi, sc.lights(), sc.env_color,
            12, finisher)
    got = tpt.bounce_step(*args)
    want = tpt.bounce_core_reference(*args)
    torch.cuda.synchronize()
    check_bounce(got, want)


@pytest.mark.parametrize("lanes", [1, 127, 129])
def test_bounce_kernel_ragged_lanes(cuda_device, lanes):
    """K2 at the step wavefront's tail widths, live-lane counts that are no
    multiple of its 128-thread block: rays from the 250-Gaussian scene's
    means (each starts inside a Gaussian, as a scattered path does), each
    ray's outputs equal bit for bit to the same ray's in a launch of all
    250 (a thread depends on no other ray), and BOUNCE_BARS against the
    plain version.  One ray cannot meet the bars' floor of more than 10
    rays that scatter in both, so it is held per ray at their
    tolerances."""
    sc = parse_gmm(random_gaussian_scene(250, seed=0), device=cuda_device)
    n = sc.medium.n
    _, d, xi = (torch.from_numpy(a).to(cuda_device)
                for a in random_rays(n, seed=3))
    o = sc.medium.mean.contiguous()
    table = tpt.pack_table(sc.medium)
    rest = (sc.lights(), sc.env_color, 12, False)
    full = tpt.bounce_step(table, o, d, xi, *rest)
    args = (table, o[:lanes].contiguous(), d[:lanes].contiguous(),
            xi[:lanes].contiguous()) + rest
    got = tpt.bounce_step(*args)
    want = tpt.bounce_core_reference(*args)
    torch.cuda.synchronize()
    for x, y in zip(got, full):
        assert torch.equal(x, y[:lanes])
    if lanes > 1:
        check_bounce(got, want)
        return
    t, scat, alb, li, tau = (x.cpu().numpy() for x in got[:5])
    t_r, scat_r, alb_r, li_r, tau_r = (x.cpu().numpy() for x in want[:5])
    assert scat.all() and scat_r.all()
    assert np.all(np.abs(tau - tau_r) <= BOUNCE_BARS["tau_atol"]
                  + BOUNCE_BARS["tau_rtol"] * np.abs(tau_r))
    assert np.all(np.abs(t - t_r) < BOUNCE_BARS["t"])
    assert np.all(np.abs(alb - alb_r) < BOUNCE_BARS["albedo"])
    assert np.all(np.abs(li - li_r) < BOUNCE_BARS["li"])


def _hold_mega(sc, cam, cfg, ids):
    """mega_call against mega_reference at atol 1e-4 on the mean radiance,
    bounce evaluations within 1 %; returns the kernel's result."""
    args = _mega_args(sc, cam, cfg, ids)
    got, want = tmt.mega_call(*args), tmt.mega_reference(*args)
    torch.cuda.synchronize()
    res = mega_agreement(got, want, cfg.spp)
    assert res["finite"] and res["max_diff"] <= 1e-4, res
    assert res["evals_rel"] <= 0.01, res
    return got


@pytest.mark.parametrize("n_lights", [3, 0])
def test_mega_kernel_matches_plain(cuda_device, n_lights):
    """Both cameras; with the generator's 3 point lights and without (NEE
    then always samples the environment)."""
    text = SCENE24 if n_lights else random_gaussian_scene(
        24, seed=7, diameter=(0.2, 0.6), density=(0.5, 2.0), lights=())
    sc = parse_gmm(text, device=cuda_device)
    assert sc.lights().shape == (n_lights, 6)
    ids = torch.arange(256, dtype=torch.int32, device=cuda_device)
    for cam in _cameras(cuda_device):
        _hold_mega(sc, cam, RenderConfig(**MEGA_KW), ids)


def test_mega_kernel_deep_bounces_ortho(cuda_device):
    """Early RR (min_scatter 1) and the tail cap (from bounce 3) inside
    max_bounces 10, through the orthographic camera."""
    sc = parse_gmm(random_gaussian_scene(16, seed=9, diameter=(0.3, 0.8),
                                         density=(1.0, 3.0)),
                   device=cuda_device)
    cfg = RenderConfig(width=8, height=8, spp=4, max_bounces=10,
                       min_scatter=1, rr_tail_after=3, rr_cap_tail=0.4)
    evals = _hold_mega(sc, _cameras(cuda_device)[1], cfg,
                       torch.arange(64, dtype=torch.int32,
                                    device=cuda_device))[1]
    # a pixel with more than 3 evaluations per sample holds a path that
    # reached bounce 3, where the tail cap applies
    assert int(evals.max()) > 3 * cfg.spp


def test_mega_kernel_ragged_chunk(cuda_device):
    """A chunk that is not a multiple of the 128-pixel block, with
    duplicate ids, matches the plain version per entry."""
    sc = parse_gmm(SCENE24, device=cuda_device)
    ids = torch.tensor(list(range(200)) + [5] * 7, dtype=torch.int32,
                       device=cuda_device)
    args = _mega_args(sc, _cameras(cuda_device)[0], RenderConfig(**MEGA_KW),
                      ids)
    got = tmt.mega_call(*args)[0]
    want = tmt.mega_reference(*args)[0]
    torch.cuda.synchronize()
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                               atol=1e-3)


@pytest.mark.parametrize("spp", [1, 64])
def test_mega_kernel_ragged_pool(cuda_device, spp):
    """A chunk of 203 pixels, not a multiple of the block's pool on this
    card (``pool_pixels``), so the last block holds fewer pixels than the
    others, matches the plain version at spp 1 and spp 64."""
    sc = parse_gmm(SCENE24, device=cuda_device)
    ids = torch.arange(3, 206, dtype=torch.int32, device=cuda_device)
    per_sm, sms = tmt.resident_blocks(cuda_device)
    assert ids.shape[0] % tmt.pool_pixels(spp, ids.shape[0], per_sm * sms)
    _hold_mega(sc, _cameras(cuda_device)[0],
               RenderConfig(**dict(MEGA_KW, spp=spp)), ids)


@pytest.mark.parametrize("ids", [[33], [33, 34, 57]])
def test_mega_kernel_tiny_chunk(cuda_device, ids):
    """1 and 3 pixels at spp 1, each path scattering at least once: a warp
    queues fewer shadow rays than a full drain takes, so only its last,
    partial drain adds their NEE radiance."""
    sc = parse_gmm(SCENE24, device=cuda_device)
    evals = _hold_mega(sc, _cameras(cuda_device)[0],
                       RenderConfig(**dict(MEGA_KW, spp=1)),
                       torch.tensor(ids, dtype=torch.int32,
                                    device=cuda_device))[1]
    assert (evals >= 2).all()


# Rays crossing many pairs: 600 Gaussians of diameter 0.1-0.25 (camera
# rays cross a median 15 pairs, some more than MAX_HITS), and the
# S_CAP_MAX fallback's kind (2,000 of diameter 2-4, every ray crossing
# hundreds).  The plain version with its rows permuted moved no pixel by
# more than 1.2e-5 and 3e-7 there (CPU), so atol 1e-4 holds.
CROWDED = {"600": dict(n=600, seed=0, diameter=(0.1, 0.25)),
           "2000": dict(n=2000, seed=0, diameter=(2.0, 4.0))}


@pytest.mark.parametrize("scene", sorted(CROWDED))
def test_mega_kernel_crowded_rays(cuda_device, scene):
    """K1 where rays cross more pairs than the pair cache holds (600:
    cached pairs, listed rows and the walk of all rows in one launch) and
    more than MAX_HITS (2000: the walk of all rows), against the plain
    version."""
    kw = dict(CROWDED[scene])
    sc = parse_gmm(random_gaussian_scene(kw.pop("n"), **kw),
                   device=cuda_device)
    cam = _cameras(cuda_device)[0]
    table = tpt.pack_table(sc.medium)
    ids = torch.arange(0, 256, 2, dtype=torch.int32, device=cuda_device)
    uv = torch.stack([(ids % 16 + 0.5) / 16, (ids // 16 + 0.5) / 16], -1)
    ray = [v[:, k][None, :] for v in cam.sample_ray(uv.float())
           for k in range(3)]
    col = lambda f: table[:, f:f + 1]
    crossed = tpt._interval(col, *ray, *tpt._coeffs(col, *ray))[-1].sum(0)
    if scene == "600":
        assert ((crossed > tpt.PAIR_CACHE)
                & (crossed <= tpt.MAX_HITS)).float().mean() > 0.3
        assert (crossed > tpt.MAX_HITS).any()
    else:
        assert (crossed > tpt.MAX_HITS).all()
    _hold_mega(sc, cam, RenderConfig(width=16, height=16, spp=4,
                                     max_bounces=4), ids)


def _headline_chunk(device, spp):
    """K1's arguments for the headline's chunk 9: the 250-Gaussian scene
    at 1024^2, the 65,536 pixels of rows 576-639 in tile order, which
    cross the medium and have the most bounce evaluations of its 16."""
    sc = parse_gmm(random_gaussian_scene(250, seed=0), device=device)
    cam = PinholeCamera.create([0, 1, 6], [0, 1, 0], math.radians(45.0),
                               device=device)
    chunk = tms.tile_ids(1024, 1024, device)[9 * 65536:10 * 65536]
    return _mega_args(sc, cam, RenderConfig(width=1024, height=1024,
                                            spp=spp), chunk)


@pytest.mark.parametrize("spp", [4, 64])
def test_mega_kernel_headline_chunk_matches_plain(cuda_device, spp):
    """K1 on the headline's chunk 9 at spp 4 and at the headline's spp 64
    against the plain version at testing.CHUNK_BARS."""
    args = _headline_chunk(cuda_device, spp)
    res = chunk_agreement(tmt.mega_call(*args), tmt.mega_reference(*args),
                          spp)
    assert res["ok"], res


def test_mega_kernel_headline_scene_matches_plain(cuda_device):
    """K1 on the headline's 250-Gaussian scene at 64^2 spp 16, every pixel
    in tile order, against the plain version: the image means within 1 %,
    the per-pixel mean |diff| below 1e-3."""
    sc = parse_gmm(random_gaussian_scene(250, seed=0), device=cuda_device)
    cfg = RenderConfig(width=64, height=64, spp=16)
    args = _mega_args(sc, _cameras(cuda_device)[0], cfg,
                      tms.tile_ids(64, 64, cuda_device))
    got, want = tmt.mega_call(*args), tmt.mega_reference(*args)
    res = mega_agreement(got, want, cfg.spp)
    m_got, m_want = (float(x[0].mean()) / cfg.spp for x in (got, want))
    assert res["finite"] and res["mean_diff"] < 1e-3, res
    assert abs(m_got - m_want) <= 0.01 * abs(m_want), (m_got, m_want)


def test_mega_kernel_reproducible(cuda_device):
    """K1 five times on the headline's chunk 9 at spp 64: the same bits
    each time, the radiance and the evaluation counts."""
    args = _headline_chunk(cuda_device, 64)
    first = tmt.mega_call(*args)
    for _ in range(4):
        again = tmt.mega_call(*args)
        assert torch.equal(again[0], first[0])
        assert torch.equal(again[1], first[1])


@pytest.mark.parametrize("spp", [1, 3, 64, 1024])
def test_mega_kernel_pool_invariant(cuda_device, monkeypatch, spp):
    """K1 with its pool forced to 1, 8 and 128 pixels a block (at spp 64
    and 1024 a pool of 8 or 128 pixels runs in rounds of the kernel's
    MEGA_ROUND paths): the same bits as with the launcher's own pool,
    radiance and evaluation counts, and the launcher's result within the
    plain version's CHUNK_BARS (at spp 1024 one path of the 207,872 flips
    a threshold test)."""
    args = _mega_args(parse_gmm(SCENE24, device=cuda_device),
                      _cameras(cuda_device)[0],
                      RenderConfig(**dict(MEGA_KW, spp=spp)),
                      torch.arange(3, 206, dtype=torch.int32,
                                   device=cuda_device))
    want = tmt.mega_call(*args)
    res = chunk_agreement(want, tmt.mega_reference(*args), spp)
    assert res["ok"], res
    for pix in (1, 8, 128):
        monkeypatch.setattr(tmt, "pool_pixels", lambda *_, p=pix: p)
        got = tmt.mega_call(*args)
        assert torch.equal(got[0], want[0]), pix
        assert torch.equal(got[1], want[1]), pix


def test_render_reproducible(cuda_device):
    """render_multiscatter of the 250-Gaussian scene at 128^2 spp 16 on the
    card: the same bits twice, and with ray_chunk 64 against 65,536 (K1's
    image does not depend on the chunk)."""
    sc = parse_gmm(random_gaussian_scene(250, seed=0), device=cuda_device)
    cam = PinholeCamera.create([0, 1, 6], [0, 1, 0], math.radians(45.0),
                               device=cuda_device)
    cfg = RenderConfig(width=128, height=128, spp=16)
    a = render_multiscatter(sc, cam, cfg, device=cuda_device)
    b = render_multiscatter(sc, cam, cfg, device=cuda_device)
    c = render_multiscatter(sc, cam, cfg.replace(ray_chunk=64),
                            device=cuda_device)
    np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(a, c)


def _step_render(device, cfg):
    stats = {}
    img = render_multiscatter(parse_gmm(SCENE24), _cameras("cpu")[0],
                              cfg.replace(wavefront="step"), device=device,
                              stats=stats)
    assert stats["kernel"] == "step" and np.isfinite(img).all()
    return img, stats


def test_step_render_on_card_matches_cpu(cuda_device):
    """The step wavefront (K8's two launches and K2 once an iteration) at
    32^2 spp 4 on the card against the same render on the CPU (K2's plain
    version), by image_agreement (CHUNK_BARS: a path whose scatter or RR
    test sits within rounding of its threshold may flip); no plain
    version, no K3 launch and no megakernel on the card."""
    cfg = RenderConfig(width=32, height=32, spp=4)
    want, _ = _step_render("cpu", cfg)
    counters = (tpt.bounce_step, tpt.bounce_core_reference,
                twf.wave_pre, twf.wave_post, twf.wave_pre_reference,
                twf.wave_post_reference, trng.wave_uniforms,
                trng.wave_uniforms_reference, tmt.mega_call,
                tmt.mega_reference)
    for fn in counters:
        fn.launches = 0
    got, stats = _step_render(cuda_device, cfg)
    res = image_agreement(got, want, cfg.spp)
    assert res["ok"], res
    it = stats["iterations"]
    assert it > 0
    assert [fn.launches for fn in counters] == [it, 0, it, it] + [0] * 6


def test_step_render_reproducible(cuda_device):
    """Two step renders of one scene and seed on the card, the same bits
    (no atomics on this path)."""
    cfg = RenderConfig(width=32, height=32, spp=8)
    a, _ = _step_render(cuda_device, cfg)
    b, _ = _step_render(cuda_device, cfg)
    np.testing.assert_array_equal(a, b)


def test_parse_40k_scene_on_the_card(cuda_device):
    """A 40,000-Gaussian scene parses on the card (its eighs in batches of
    EIGH_BATCH: one batch of 40,000 makes cuSOLVER raise), its
    eigenvalues within 1e-5 relative of the CPU's parse."""
    text = random_gaussian_scene(40_000, seed=12)
    card = parse_gmm(text, device=cuda_device).medium
    cpu = parse_gmm(text).medium
    np.testing.assert_allclose(card.eigvals.cpu().numpy(),
                               cpu.eigvals.numpy(), rtol=1e-5, atol=1e-12)


def test_render_on_card_matches_cpu(cuda_device):
    cfg = RenderConfig(width=16, height=16, spp=9)
    for cam in _cameras("cpu"):
        want = render_multiscatter(parse_gmm(SCENE24), cam, cfg,
                                   device="cpu")
        got = render_multiscatter(parse_gmm(SCENE24), cam, cfg,
                                  device=cuda_device)
        np.testing.assert_allclose(got, want, atol=1e-4)


def test_wrappers_refuse_bad_inputs(cuda_device):
    sc = parse_gmm(SCENE24, device=cuda_device)
    table = tpt.pack_table(sc.medium)
    o, d, xi = (torch.from_numpy(a).to(cuda_device)
                for a in random_rays(64, seed=2))
    with pytest.raises(ValueError, match="dtype"):
        tpt.bounce_step(table.double(), o, d, xi, sc.lights(), sc.env_color)
    with pytest.raises(ValueError, match="on cpu"):
        tpt.bounce_step(table, o.cpu(), d, xi, sc.lights(), sc.env_color)
    ids = torch.arange(8, dtype=torch.int64, device=cuda_device)
    with pytest.raises(ValueError, match="ids"):
        tmt.mega_call(*_mega_args(sc, _cameras(cuda_device)[0],
                                  RenderConfig(**MEGA_KW), ids))


def _grid_rays(cuda_device, n=8192, seed=3):
    o, d, _ = random_rays(n, seed=seed)
    return (torch.from_numpy(o).to(cuda_device),
            torch.from_numpy(d).to(cuda_device))


@pytest.mark.parametrize("with_tmax", [False, True])
def test_span_tau_kernel_matches_plain(cuda_device, with_tmax):
    """K6 per crossing at testing.K6_BARS (the bounce bars' tau tolerance
    plus float32 resolution) on a 2,000-Gaussian grid."""
    sc = parse_gmm(random_gaussian_scene(2000, seed=1), device=cuda_device)
    grid = build_grid(sc.medium)
    o, d = _grid_rays(cuda_device)
    tmax = torch.linspace(0.1, 4.0, o.shape[0], device=cuda_device) \
        if with_tmax else torch.full((o.shape[0],), 1e8, device=cuda_device)
    cells, _, t_out = dda_crossings(grid, o, d,
                                    tmax if with_tmax else None)
    got = tgt.span_tau_pass(grid, o, d, tmax, cells)
    want = tgt.span_tau_reference(grid, o, d, tmax, cells)
    torch.cuda.synchronize()
    res = span_tau_agreement(got, want, grid, cells, t_out)
    assert res["slots"] > 1000 and res["ok"], res


@pytest.mark.parametrize("case", ["empty cells", "clipped spans",
                                  "crowded cells"])
def test_span_tau_kernel_slot_edges(cuda_device, case):
    """K6 against its plain version on a 2,000-Gaussian grid, whose live
    slots have cells of up to ~200 entries, beside empty slots (cell -1)
    that its blocks drop before the walk: with a third of the occupied
    cells emptied (count 0), or with the cells of the whole line and a
    tmax of 0.3-3 that leaves many later slots' spans empty.  Those slots
    give exactly 0, the others meet K6_BARS.  And on 600 Gaussians of
    diameter 1-2 on a 3^3 grid, where a ray crosses most entries of its
    cells, so a walk that strays past a cell's last entry (its rows are
    pre-tested K6_UNROLL at a time) adds a pair of the next cell."""
    import dataclasses
    text = (random_gaussian_scene(600, seed=0, diameter=(1.0, 2.0))
            if case == "crowded cells" else
            random_gaussian_scene(2000, seed=1))
    sc = parse_gmm(text, device=cuda_device)
    grid = build_grid(sc.medium)
    o, d = _grid_rays(cuda_device)
    n = o.shape[0]
    if case == "crowded cells":
        tmax = torch.full((n,), 1e8, device=cuda_device)
    elif case == "empty cells":
        drop = torch.arange(grid.n_cells, device=cuda_device) % 3 == 0
        grid = dataclasses.replace(grid, cell_count=torch.where(
            drop, 0, grid.cell_count).to(torch.int32).contiguous())
        tmax = torch.full((n,), 1e8, device=cuda_device)
    else:
        tmax = torch.linspace(0.3, 3.0, n, device=cuda_device)
    cells, t_in, t_out = dda_crossings(grid, o, d)
    got = tgt.span_tau_pass(grid, o, d, tmax, cells)
    want = tgt.span_tau_reference(grid, o, d, tmax, cells)
    torch.cuda.synchronize()
    res = span_tau_agreement(got, want, grid, cells, t_out)
    assert res["slots"] > 1000 and res["ok"], res
    counts = grid.cell_count[cells.clamp(min=0).long()]
    # empty slots, empty cells, and cells the segment reaches only past
    # tmax (by a margin over the rounding of the two clips)
    empty = (cells < 0) | (counts == 0) | (t_in > tmax[:, None] + 1e-4)
    assert bool((cells < 0).any()) and not bool(got[empty].any())
    visited, crossed = tgt.span_work(grid, o, d, tmax, cells)
    assert int((got > 0).sum()) > 500
    if case == "crowded cells":
        assert int(crossed.sum()) > 0.5 * int(visited.sum())
        assert bool((counts[visited > 0] % 2 == 1).any())
    else:
        assert int(((cells >= 0) & empty).sum()) > 100
        assert bool((counts[visited > 0] > 32).any())


@pytest.mark.parametrize("n", [120, 2000])
def test_grid_solve_kernel_matches_plain(cuda_device, n):
    """K7 on the critical cells of random rays at testing.K7_BARS: t to
    float32 rounding on 99.9 % of the rays (a root next to a threshold may
    take the other branch on a few), the albedo on those rays.  The fat
    Gaussians of the 120 overlap at most roots (the mixture albedo); the
    2,000 leave one active at most roots (the finisher's case)."""
    text = SCENE120 if n == 120 else random_gaussian_scene(2000, seed=1)
    sc = parse_gmm(text, device=cuda_device)
    grid = build_grid(sc.medium)
    o, d = _grid_rays(cuda_device)
    u = torch.from_numpy(np.random.default_rng(11).uniform(
        0.01, 0.99, o.shape[0]).astype(np.float32)).to(cuda_device)
    _, _, cells, t_in, t_out, resid = critical_crossing(
        grid, *grid_tau_crossings(grid, o, d), u)
    args = (grid, o, d, t_in, t_out, resid, cells, 6)
    got, want = tgt.solve_pass(*args), tgt.solve_reference(*args)
    torch.cuda.synchronize()
    res = solve_agreement(got, want, cells)
    assert res["n"] > 1000 and res["ok"], res


def test_grid_solve_kernel_overflow(cuda_device):
    """K7 where nearly every ray crosses more than MAX_HITS entries of its
    critical cell (600 Gaussians of diameter 1-2 on a 3^3 grid), so its
    Newton, finisher and albedo passes walk the whole cell: at
    testing.K7_BARS (the plain version in float64 kept every t within
    them here, CPU)."""
    sc = parse_gmm(random_gaussian_scene(600, seed=0, diameter=(1.0, 2.0)),
                   device=cuda_device)
    grid = build_grid(sc.medium)
    o, d = _grid_rays(cuda_device, n=4096)
    u = torch.from_numpy(np.random.default_rng(11).uniform(
        0.01, 0.99, o.shape[0]).astype(np.float32)).to(cuda_device)
    _, _, cells, t_in, t_out, resid = critical_crossing(
        grid, *grid_tau_crossings(grid, o, d), u)
    live = cells >= 0
    crossed = tgt.crossed_entries(grid, o, d, t_in, t_out, cells)
    assert (crossed[live] > tpt.MAX_HITS).float().mean() > 0.9
    args = (grid, o, d, t_in, t_out, resid, cells, 6)
    got, want = tgt.solve_pass(*args), tgt.solve_reference(*args)
    torch.cuda.synchronize()
    res = solve_agreement(got, want, cells)
    assert res["n"] > 1000 and res["ok"], res


def test_grid_engine_matches_megakernel(cuda_device):
    """engine='grid' forced against the dense megakernel on one scene:
    the same estimator, so image means agree within 1 % at 64^2 spp 16;
    only the grid's kernels run and no plain version is called."""
    sc = parse_gmm(SCENE120, device=cuda_device)
    cam = _cameras(cuda_device)[0]
    cfg = RenderConfig(width=64, height=64, spp=16)
    counters = (tgt.span_tau_pass, tgt.solve_pass, tgt.span_tau_reference,
                tgt.solve_reference, tmt.mega_call)
    for fn in counters:
        fn.launches = 0
    img_g = render_multiscatter(sc, cam, cfg.replace(engine="grid"),
                                device=cuda_device)
    launches = [fn.launches for fn in counters]
    img_d = render_multiscatter(sc, cam, cfg.replace(engine="dense"),
                                device=cuda_device)
    assert launches[0] > 0 and launches[1] > 0 and launches[2:] == [0, 0, 0]
    assert np.isfinite(img_g).all() and img_g.std() > 0
    np.testing.assert_allclose(img_g.mean(), img_d.mean(), rtol=1e-2)


def test_grid_kernels_at_the_main_paths_shapes(cuda_device, scene10k):
    """K6 and K7 at one iteration of the grid main path, the 10k scene at
    512^2: K7 on the critical cells of the GRID_CHUNK camera rays of
    tile-order chunk 4 (rows 256-319, the centre) at testing.K7_BARS, and
    K6 over the crossings of those rays and of their NEE rays from the
    scatter points at testing.K6_BARS."""
    sc = scene10k.to(cuda_device)
    grid = build_grid(sc.medium)
    n = tms.GRID_CHUNK
    cam = PinholeCamera.create([0, 1, 6], [0, 1, 0], math.radians(45.0),
                               device=cuda_device)
    px = tms.tile_ids(512, 512, cuda_device)[4 * n:5 * n]
    o, d = cam.sample_ray(torch.stack([(px % 512 + 0.5) / 512,
                                       (px // 512 + 0.5) / 512], -1).float())
    xi = torch.from_numpy(np.random.default_rng(1).uniform(
        size=(n, 5)).astype(np.float32)).to(cuda_device)
    scattered, _, cells, t_in, t_out, resid = critical_crossing(
        grid, *grid_tau_crossings(grid, o, d), xi[:, 0])
    args = (grid, o, d, t_in, t_out, resid, cells, 6)
    got, want = tgt.solve_pass(*args), tgt.solve_reference(*args)
    res = solve_agreement(got, want, cells)
    assert res["n"] > 1000 and res["ok"], res
    pos = o + torch.clamp(got[0], min=0.0)[:, None] * d
    wi, tmax_nee, _, _ = _nee_select(sc, pos, xi[:, 1], xi[:, 2], xi[:, 3:5])
    o2, d2 = torch.cat([o, pos]), torch.cat([d, wi])
    tmax = torch.cat([torch.full((n,), 1e8, device=cuda_device),
                      torch.where(scattered, tmax_nee, 0.0)])
    cells2, _, t_out2 = dda_crossings(grid, o2, d2, tmax)
    got = tgt.span_tau_pass(grid, o2, d2, tmax, cells2)
    want = tgt.span_tau_reference(grid, o2, d2, tmax, cells2)
    torch.cuda.synchronize()
    res = span_tau_agreement(got, want, grid, cells2, t_out2)
    assert res["slots"] > 1000 and res["ok"], res


def test_grid_wrappers_refuse_bad_inputs(cuda_device):
    sc = parse_gmm(SCENE120, device=cuda_device)
    grid = build_grid(sc.medium)
    o, d = _grid_rays(cuda_device, n=64)
    tmax = torch.full((64,), 1e8, device=cuda_device)
    cells, _, _ = dda_crossings(grid, o, d)
    with pytest.raises(ValueError, match="cells"):
        tgt.span_tau_pass(grid, o, d, tmax, cells.long())
    with pytest.raises(ValueError, match="tmax"):
        tgt.span_tau_pass(grid, o, d, tmax.cpu(), cells)


@pytest.fixture(scope="module")
def scene10k():
    """random_gaussian_scene(10_000, 0), Morton-sorted by the parser: 40
    chunks of 256 for K4/K5."""
    return parse_gmm(random_gaussian_scene(10_000, seed=0))


def _big_inputs(sc):
    return tpb.pack_rows(sc.medium), tpb.chunk_boxes(sc.medium)


@pytest.mark.parametrize("lights", ["scene", "none", "inside"])
def test_big_kernels_match_plain(cuda_device, scene10k, lights):
    """K4 and K5 against their plain versions at testing.BIG_BARS on the
    10k scene (2,048 camera rays through the medium, 2,048 rays from
    inside it): with the scene's 3 lights, with none (NEE always to the
    env), and with one light inside the medium, where K5's tmax clip
    decides Li (the scene's lights lie outside it); each kernel's box test
    admits the chunks the plain one does."""
    sc = scene10k.to(cuda_device)
    lts = {"scene": sc.lights(), "none": sc.lights()[:0],
           "inside": torch.tensor([[0.0, 1.0, 0.0, 5.0, 5.0, 5.0]],
                                  device=cuda_device)}[lights]
    o, d, xi = big_rays(sc.medium, 2048, seed=3, device=cuda_device)
    res = big_kernel_vs_plain(*_big_inputs(sc), o, d, xi, lts, sc.env_color)
    assert res["ok"] and res["n_both"] > 1000, str(res)


@pytest.mark.parametrize("n", [1, 31, 33, 4095, 65_536])
def test_big_kernels_at_ray_counts(cuda_device, scene10k, n):
    """K4 and K5 at ray counts around a warp and a block of warps (a
    padded last block) up to a chunk's 65,536 lanes, on the first n of
    65,536 big_rays: the whole batch against the plain versions at
    BIG_BARS; fewer rays the same bits as the whole batch's first n, the
    chunks and groups each kernel admitted equal to
    admitted_counts_reference, and K4's overflow count equal to the rays
    that cross more than MAX_HITS pairs."""
    sc = scene10k.to(cuda_device)
    table, boxes = _big_inputs(sc)
    o, d, xi = big_rays(sc.medium, 32_768, seed=5, device=cuda_device)
    if n == 65_536:
        res = big_kernel_vs_plain(table, boxes, o, d, xi, sc.lights(),
                                  sc.env_color)
        assert res["ok"] and res["n_both"] > 10_000, str(res)
        return
    s1_all = tpb.big_stage1(table, o, d, xi, sc.lights(), boxes=boxes)
    li_all = tpb.big_nee(table, s1_all, sc.env_color, boxes)
    o, d, xi = o[:n], d[:n], xi[:n]
    adm4, adm5 = (torch.zeros((2, n), dtype=torch.int32, device=cuda_device)
                  for _ in range(2))
    over = torch.zeros(1, dtype=torch.int32, device=cuda_device)
    s1 = tpb.big_stage1(table, o, d, xi, sc.lights(), boxes=boxes,
                        admitted=adm4, overflow=over)
    li = tpb.big_nee(table, s1, sc.env_color, boxes, adm5)
    assert torch.equal(s1, s1_all[:, :n]) and torch.equal(li, li_all[:n])
    assert torch.equal(adm4, tpb.admitted_counts_reference(boxes, o, d))
    assert torch.equal(adm5, tpb.admitted_counts_reference(
        boxes, s1[4:7].T, s1[7:10].T, s1[10]))
    crossed = tpb.culling_stats(table, boxes, o, d)["crossed"]
    assert int(over) == int((crossed > tpb.MAX_HITS).sum())


@pytest.fixture(scope="module")
def fallback_scene():
    """The S_CAP_MAX fallback scene: 8,000 Gaussians of diameter 2-4, 32
    chunks (the last 75 % padding), every ray crossing all of them."""
    return parse_gmm(random_gaussian_scene(8000, seed=0,
                                           diameter=(2.0, 4.0)))


def test_big_kernels_match_plain_fallback(cuda_device, fallback_scene):
    """K4 and K5 against their plain versions on the fallback scene, where
    nearly every ray crosses more than MAX_HITS pairs, so K4's Newton and
    albedo passes recompute the rows of its marked groups: at
    testing.BIG_DENSE_BARS, with K4's overflow count equal to those
    rays."""
    sc = fallback_scene.to(cuda_device)
    table, boxes = _big_inputs(sc)
    o, d, xi = big_rays(sc.medium, 2048, seed=4, device=cuda_device)
    crossed = tpb.culling_stats(table, boxes, o, d)["crossed"]
    assert (crossed > tpb.MAX_HITS).float().mean() > 0.9
    res = big_kernel_vs_plain(table, boxes, o, d, xi, sc.lights(),
                              sc.env_color, bars=BIG_DENSE_BARS)
    assert res["ok"] and res["n_both"] > 1000, str(res)


def test_big_kernels_box_edges(cuda_device, scene10k):
    """Rays from inside the chunk boxes (their centres and corners, in
    random and axis directions) through K4 and K5 against their plain
    versions at BIG_BARS; and NEE segments that end before a chunk's box
    (from outside it toward its centre, tmax half the way to its entry)
    through K5: Li equal to the plain version's within the Li bar, and the
    chunks and groups admitted equal to the plain box tests over
    [0, tmax], which admit fewer than over [0, inf)."""
    sc = scene10k.to(cuda_device)
    table, boxes = _big_inputs(sc)
    r = np.random.default_rng(6)
    lo, hi = (boxes[:, 0, k:k + 3].cpu().numpy() for k in (0, 4))
    n_c = lo.shape[0]
    pick = r.integers(0, n_c, 4096)
    w = np.where(np.arange(4096)[:, None] < 2048, 0.5,
                 r.integers(0, 2, (4096, 3)))
    o = lo[pick] + w * (hi[pick] - lo[pick])
    d = r.normal(size=(4096, 3))
    d[:1024] = 0.0
    d[np.arange(1024), r.integers(0, 3, 1024)] = r.choice([-1.0, 1.0], 1024)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    xi = r.uniform(size=(4096, 5))
    f32 = lambda a: torch.tensor(a, dtype=torch.float32, device=cuda_device)
    res = big_kernel_vs_plain(table, boxes, f32(o), f32(d), f32(xi),
                              sc.lights(), sc.env_color)
    assert res["ok"] and res["n_both"] > 1000, str(res)

    centre = 0.5 * (lo + hi)
    u = r.normal(size=(n_c, 3))
    u /= np.linalg.norm(u, axis=1, keepdims=True)
    p = centre + u * (np.linalg.norm(hi - lo, axis=1, keepdims=True) + 0.5)
    w_dir = (centre - p) / np.linalg.norm(centre - p, axis=1, keepdims=True)
    t_in = ((np.where(w_dir > 0, lo, hi) - p) / w_dir).max(1)
    s1 = torch.zeros((tpb.STAGE1_ROWS, n_c), device=cuda_device)
    s1[4:7], s1[7:10] = f32(p).T, f32(w_dir).T
    s1[10], s1[11] = f32(0.5 * t_in), 1.0
    adm = torch.zeros((2, n_c), dtype=torch.int32, device=cuda_device)
    li = tpb.big_nee(table, s1, sc.env_color, boxes, adm)
    want = tpb.big_nee_reference(table, s1, sc.env_color)
    np.testing.assert_allclose(li.cpu().numpy(), want.cpu().numpy(),
                               atol=1e-4, rtol=1e-3)
    seg = (s1[4:7].T, s1[7:10].T)
    assert torch.equal(adm, tpb.admitted_counts_reference(boxes, *seg,
                                                          s1[10]))
    cut = tpb.admitted_reference(boxes, *seg, s1[10])[0]
    ray = tpb.admitted_reference(boxes, *seg)[0]
    assert not cut[torch.arange(n_c), torch.arange(n_c)].any()
    assert ray[torch.arange(n_c), torch.arange(n_c)].all()


def test_big_kernels_padded_last_chunk(cuda_device):
    """A scene whose last chunk is mostly padding (2,100 Gaussians: 52 of
    the last chunk's 256 rows): rays aimed at the last chunk's Gaussians
    from the camera and from inside its box, most with a low scatter
    target, through K4 and K5 against their plain versions at BIG_BARS."""
    sc = parse_gmm(random_gaussian_scene(2100, seed=0), device=cuda_device)
    table, boxes = _big_inputs(sc)
    last = sc.medium.mean[(table.shape[0] // tpb.G - 1) * tpb.G:]
    assert last.shape[0] == 2100 - 8 * tpb.G
    r = np.random.default_rng(7)
    f32 = lambda a: torch.tensor(a, dtype=torch.float32, device=cuda_device)
    target = last[torch.from_numpy(r.integers(0, last.shape[0], 2048))
                  .to(cuda_device)]
    o = torch.cat([f32(np.tile([0.0, 1.0, 6.0], (1024, 1))),
                   f32(r.uniform(boxes[-1, 0, 0:3].cpu().numpy(),
                                 boxes[-1, 0, 4:7].cpu().numpy(),
                                 (1024, 3)))])
    d = torch.nn.functional.normalize(target - o, dim=1).contiguous()
    xi = f32(r.uniform(size=(2048, 5)))
    xi[:1536, 0] *= 1e-3
    res = big_kernel_vs_plain(table, boxes, o, d, xi, sc.lights(),
                              sc.env_color)
    assert res["ok"] and res["n_both"] > 500, str(res)


@pytest.mark.parametrize("scene", ["10k", "fallback"])
def test_chunk_boxes_hold_every_crossed_chunk(cuda_device, scene10k,
                                              fallback_scene, scene):
    """On the card, at the main paths' scale: every chunk and every 32-row
    group holding a pair that a ray crosses (camera rays, rays from inside
    the medium, and K4's NEE segments with their tmax) is admitted by the
    box tests, and the kernels' pre-test passes every such pair, so the
    kernels' culls add exactly 0."""
    sc = (scene10k if scene == "10k" else fallback_scene).to(cuda_device)
    table, boxes = _big_inputs(sc)
    o, d, xi = big_rays(sc.medium, 2048, seed=8, device=cuda_device)
    s1 = tpb.big_stage1(table, o, d, xi, sc.lights(), boxes=boxes)
    col = lambda f: table[:, f:f + 1]
    for oo, dd, tmax in ((o, d, None), (s1[4:7].T, s1[7:10].T, s1[10])):
        ray = [v[:, k][None, :] for v in (oo, dd) for k in range(3)]
        t0, t1, _, ok = tpt._interval(col, *ray, *tpt._coeffs(col, *ray))
        if tmax is not None:
            ok = ok & (torch.minimum(t1, tmax[None, :]) > t0)
        hit = ok.reshape(-1, 8, tpb.GROUP, ok.shape[1]).any(2).permute(
            2, 0, 1)
        chunks, groups = tpb.admitted_reference(boxes, oo, dd, tmax)
        assert hit.any() and not (hit & ~groups).any()
        assert not (hit.any(2) & ~chunks).any()
        assert not (ok & ~tpb.may_cross_reference(table, oo, dd)).any()


def test_big_wavefront_kernel_matches_plain(cuda_device):
    """The big-N wavefront on the card (K3, K4, K5) against its plain run
    on the CPU at 2,100 Gaussians, 16^2 spp 4: the bars of the CPU test
    against JAX (median |diff| < 1e-4, image means within 0.5 %)."""
    sc = parse_gmm(random_gaussian_scene(2100, seed=0))
    cfg = RenderConfig(width=16, height=16, spp=4, max_bounces=4)
    cam = _cameras("cpu")[0]
    ids = torch.arange(256, dtype=torch.int32)
    want = wavefront_pixels_big(sc, cam, cfg, ids).numpy()
    got = wavefront_pixels_big(sc.to(cuda_device), cam.to(cuda_device), cfg,
                               ids.to(cuda_device)).cpu().numpy()
    assert np.isfinite(got).all() and got.std() > 0
    assert np.median(np.abs(got - want)) < 1e-4
    assert abs(got.mean() - want.mean()) < 5e-3 * want.mean()


def test_big_render_launches_the_kernels(cuda_device):
    """engine='dense' above 2,048 Gaussians renders through K4 and K5, one
    launch each an iteration enqueued (those with live lanes and the spare
    ones past the end, which the loop enqueues before it has read that
    the chunk ended), and calls no plain version."""
    counters = (tpb.big_stage1, tpb.big_nee, tpb.big_stage1_reference,
                tpb.big_nee_reference, tmt.mega_call)
    for fn in counters:
        fn.launches = 0
    stats = {}
    img = render_multiscatter(
        parse_gmm(random_gaussian_scene(2100, seed=0)),
        _cameras(cuda_device)[0],
        RenderConfig(width=32, height=32, spp=2, engine="dense"),
        device=cuda_device, stats=stats)
    assert np.isfinite(img).all() and img.std() > 0
    assert stats["kernel"] == "big" and stats["iterations"] > 0
    enqueued = stats["iterations"] + stats["spare_iterations"]
    assert [fn.launches for fn in counters] == [enqueued] * 2 + [0, 0, 0]


def test_big_loop_on_card_matches_the_host_read_loop(cuda_device):
    """The big-N loop on the card (K8 in list mode, K4 and K5 reading the
    live count on the card) against the loop that reads the live lanes on
    the host each iteration (K8 in host mode, K4 and K5 sized by that
    read) at 2,100 Gaussians, 32^2 spp 4 in one chunk: the same image bit
    for bit, the same iterations, bounce evaluations, lanes_traced and
    lane_slots, and at most LIVE_READ_LEAD spare iterations."""
    sc = parse_gmm(random_gaussian_scene(2100, seed=0), device=cuda_device)
    cam = _cameras(cuda_device)[0]
    cfg = RenderConfig(width=32, height=32, spp=4)
    ids = tms.tile_ids(32, 32, cuda_device)
    (img, st, rec), (want, st_w, rec_w) = big_loops(sc, cam, cfg, ids)
    assert img.std() > 0 and torch.equal(img, want)
    assert st["iterations"] == st_w["iterations"] > 0
    assert int(st["bounce_evals"]) == st_w["bounce_evals"]
    for k in ("lanes_traced", "lane_slots"):
        assert rec[k] == rec_w[k], k
    assert rec["wavefront_spare_iterations"] == st["spare_iterations"] \
        <= tms.LIVE_READ_LEAD


# ---- K8, the dense wavefront's glue ----------------------------------------

def _clone_lanes(lanes):
    return twf.Lanes(**{k: v.clone() if torch.is_tensor(v) else v
                        for k, v in vars(lanes).items()})


def _lanes_equal(a, b):
    """Names of the lane fields in which a and b differ in any bit (slot
    and want are the kernel's own)."""
    return [k for k in ("o", "d", "thr", "acc", "alive", "sample",
                        "bounce")
            if not torch.equal(getattr(a, k), getattr(b, k))]


@pytest.mark.parametrize("camera", ["pinhole", "orthographic"])
def test_wave_kernel_matches_plain(cuda_device, camera):
    """K8 against its plain version run eagerly on the card, bit for bit,
    on 65,536 random lane states (testing.random_lanes: dead, finished and
    live lanes, regeneration at the last sample, bounce max_bounces - 1):
    the pre-bounce launch's gathered rays and draws and its lane state,
    then the post-bounce launch on one set of random bounce results, Li
    in both layouts the bounces give, with roulette draws exactly at and
    one ulp above the survival probability on chosen lanes."""
    cam = _cameras(cuda_device)[camera == "orthographic"]
    cfg = RenderConfig(width=320, height=205, spp=9, max_bounces=6,
                       min_scatter=1, rr_tail_after=3, seed=2**31 + 7)
    lanes, live, res, edges = random_lanes(cfg, cam, 65_536, cuda_device,
                                           seed=4)
    plain = _clone_lanes(lanes)
    got = twf.wave_pre(lanes, live, cfg)
    want = twf.wave_pre_reference(plain, live, cfg)
    for name, g, w in zip(("o", "d", "xi", "xr"), got, want):
        assert torch.equal(g, w), name
    assert _lanes_equal(lanes, plain) == []
    xr = got[3].clone()
    xr[0] = edges(plain, xr[0])
    for li_t in (False, True):
        r = res if not li_t else res[:3] + (res[3].T.contiguous().T,)
        k, p = _clone_lanes(lanes), _clone_lanes(plain)
        want_mask = twf.wave_post_reference(p, live, xr, r, 4.0,
                                            torch.tensor([0.3, 0.5, 0.9],
                                                         device=cuda_device),
                                            cfg)
        got_mask = twf.wave_post(k, live, xr, r, 4.0,
                                 torch.tensor([0.3, 0.5, 0.9],
                                              device=cuda_device), cfg)
        assert torch.equal(got_mask, want_mask)
        assert _lanes_equal(k, p) == []


def test_wave_kernel_list_mode_matches_plain(cuda_device):
    """K8 in list mode (``bind_wave_pre``, ``bind_wave_post``: the live
    list and its count on the card, the grid sized by the capacity)
    against its plain version on 65,536 random lane states
    (testing.random_lanes), bit for bit: the bounce's inputs in the
    list's first rows, every lane's state (a lane outside the list keeps
    its bounce, which the plain version counts on), and the next list, in
    any order, with its count; then a launch of each with a count of 0,
    which changes nothing."""
    cam = _cameras(cuda_device)[0]
    cfg = RenderConfig(width=320, height=205, spp=9, max_bounces=6,
                       min_scatter=1, rr_tail_after=3, seed=2**31 + 7)
    b = 65_536
    lanes, live, res, edges = random_lanes(cfg, cam, b, cuda_device, seed=4)
    n = live.shape[0]
    plain, start = _clone_lanes(lanes), _clone_lanes(lanes)
    lists = torch.zeros((2, b), dtype=torch.int64, device=cuda_device)
    lists[0, :n] = live
    counts = torch.tensor([n, 0, 0], dtype=torch.int32, device=cuda_device)
    pre, out = twf.bind_wave_pre(lanes, cfg)
    pre(lists[0].data_ptr(), b, counts.data_ptr())
    want = twf.wave_pre_reference(plain, live, cfg)
    for name, g, w in zip(("o", "d", "xi"), out, want):
        assert torch.equal(g[:n], w), name
    assert torch.equal(out[3][:, :n], want[3])
    assert _lanes_equal(lanes, plain) == []
    xr = out[3]
    xr[0, :n] = edges(plain, xr[0, :n])
    pad = lambda t: torch.cat([t, torch.zeros((b - n,) + t.shape[1:],
                                              dtype=t.dtype,
                                              device=cuda_device)])
    res_b = (pad(res[0]), pad(res[1].float()), pad(res[2]), pad(res[3]))
    env = torch.tensor([0.3, 0.5, 0.9], device=cuda_device)
    post = twf.bind_wave_post(lanes, xr, res_b, 4.0, env, cfg)
    post(lists[0].data_ptr(), b, counts.data_ptr(), lists[1].data_ptr(),
         counts.data_ptr() + 4)
    mask = twf.wave_post_reference(plain, live, xr[:, :n].contiguous(), res,
                                   4.0, env, cfg)
    bounce = plain.bounce.clone()
    outside = torch.ones(b, dtype=torch.bool, device=cuda_device)
    outside[live] = False
    bounce[outside] = start.bounce[outside]
    plain.bounce = bounce
    assert _lanes_equal(lanes, plain) == []
    m = int(counts[1])
    assert m == int(mask.sum()) > 0
    assert torch.equal(lists[1, :m].sort().values,
                       torch.nonzero(mask).squeeze(1))
    before = _clone_lanes(lanes)
    zero = counts.data_ptr() + 8
    pre(lists[1].data_ptr(), b, zero)
    post(lists[1].data_ptr(), b, zero, lists[0].data_ptr(), zero)
    assert _lanes_equal(lanes, before) == [] and int(counts[2]) == 0


@pytest.mark.parametrize("engine", ["big", "step", "xla"])
def test_wavefront_image_same_with_plain_glue(cuda_device, monkeypatch,
                                              engine):
    """render_multiscatter at 128^2 spp 16 through the big-N, step and
    XLA engines on the card: the same bytes with K8 as with its plain
    version run eagerly on the card (the eager loop K8 replaced); on the
    big-N path, whose loop binds its launches once a chunk, its plain
    step (K8's plain versions and K4/K5 sized by a host read)."""
    n, kw = {"big": (2100, dict(engine="dense")),
             "step": (250, dict(wavefront="step")),
             "xla": (250, dict(solver=Solver.BISECTION))}[engine]
    sc = parse_gmm(random_gaussian_scene(n, seed=0), device=cuda_device)
    cam = _cameras(cuda_device)[0]
    cfg = RenderConfig(width=128, height=128, spp=16, **kw)
    stats = {}
    got = render_multiscatter(sc, cam, cfg, device=cuda_device, stats=stats)
    assert stats["kernel"] == engine
    monkeypatch.setattr(tms, "wave_pre", twf.wave_pre_reference)
    monkeypatch.setattr(tms, "wave_post", twf.wave_post_reference)
    monkeypatch.setattr(tms, "_big_kernel_step", tms._big_plain_step)
    before = twf.wave_pre.launches
    want = render_multiscatter(sc, cam, cfg, device=cuda_device)
    assert twf.wave_pre.launches == before
    assert np.isfinite(got).all() and got.std() > 0
    assert got.tobytes() == want.tobytes()


def test_wave_wrappers_refuse_bad_inputs(cuda_device):
    cfg = RenderConfig(width=16, height=16, spp=4)
    ids = torch.arange(256, dtype=torch.int32, device=cuda_device)
    lanes = twf.lanes(ids, _cameras(cuda_device)[0])
    live = torch.arange(256, device=cuda_device)
    with pytest.raises(ValueError, match="live"):
        twf.wave_pre(lanes, live.int(), cfg)
    lanes.sample = lanes.sample.long()
    with pytest.raises(ValueError, match="sample"):
        twf.wave_pre(lanes, live, cfg)


def test_big_wrappers_refuse_bad_tables(cuda_device):
    o, d, xi = (torch.from_numpy(a).to(cuda_device)
                for a in random_rays(64, seed=2))
    lights = torch.zeros((0, 6), device=cuda_device)
    for rows, match in ((97 * 256, "engine='grid'"), (300, "multiple")):
        table = torch.zeros((rows, 16), device=cuda_device)
        with pytest.raises(ValueError, match=match):
            tpb.big_stage1(table, o, d, xi, lights)
    with pytest.raises(ValueError, match="on cpu"):
        tpb.big_stage1(torch.zeros((256, 16), device=cuda_device), o.cpu(),
                       d, xi, lights)


def test_big_wrappers_refuse_bad_boxes(cuda_device):
    """A CUDA table needs the scene's chunk boxes: missing, of another
    chunk count or on another device, the wrappers raise."""
    sc = parse_gmm(random_gaussian_scene(2100, seed=0), device=cuda_device)
    table, boxes = _big_inputs(sc)
    o, d, xi = (torch.from_numpy(a).to(cuda_device)
                for a in random_rays(64, seed=2))
    for bad, match in ((None, "chunk_boxes"), (boxes[:-1], "shape"),
                       (boxes.cpu(), "on cpu")):
        with pytest.raises(ValueError, match=match):
            tpb.big_stage1(table, o, d, xi, sc.lights(), boxes=bad)
        with pytest.raises(ValueError, match=match):
            tpb.big_nee(table, torch.zeros((16, 64), device=cuda_device),
                        sc.env_color, bad)


# ---- the dense XLA engine and the other integrators on the card --------

def test_tau_coeffs_ignore_the_tf32_flag(cuda_device):
    """The quadratics are elementwise multiply-adds, so a caller's TF32
    matmul setting leaves every ray-Gaussian quantity as it is."""
    sc = parse_gmm(random_gaussian_scene(250, seed=0), device=cuda_device)
    o, d, _ = (torch.from_numpy(a).to(cuda_device)
               for a in random_rays(4096, seed=3))
    flags = (torch.backends.cuda.matmul.allow_tf32,
             torch.get_float32_matmul_precision())
    try:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.set_float32_matmul_precision("highest")
        want = tto.tau_coeffs(sc.medium, o, d)
        torch.backends.cuda.matmul.allow_tf32 = True
        torch.set_float32_matmul_precision("high")
        got = tto.tau_coeffs(sc.medium, o, d)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = flags[0]
        torch.set_float32_matmul_precision(flags[1])
    assert bool(want.hit.any())
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("solver", ["bisection", "analytic_bisection",
                                    "uniform"])
def test_xla_engine_on_card_matches_cpu(cuda_device, solver):
    """The XLA engine at 16^2 spp 9 on the card against the CPU
    (testing.CARD_CPU_BARS), with K8's two launches once an iteration (its
    draws inline, no K3 launch) and no megakernel or plain version
    called."""
    cfg = RenderConfig(width=16, height=16, spp=9, solver=Solver(solver),
                       candidate_k=8 if solver == "uniform" else 0)
    cam = _cameras("cpu")[0]
    want = render_multiscatter(parse_gmm(SCENE24), cam, cfg, device="cpu")
    counters = (twf.wave_pre, twf.wave_post, twf.wave_pre_reference,
                twf.wave_post_reference, trng.wave_uniforms,
                trng.wave_uniforms_reference, trng.planes_uniforms,
                trng.planes_uniforms_reference, tmt.mega_call,
                tmt.mega_reference)
    for fn in counters:
        fn.launches = 0
    stats = {}
    got = render_multiscatter(parse_gmm(SCENE24), cam, cfg,
                              device=cuda_device, stats=stats)
    assert (stats["engine"], stats["kernel"]) == ("dense", "xla")
    it = stats["iterations"]
    assert [fn.launches for fn in counters] == [it, it] + [0] * 8
    res = card_cpu_agreement(got, want)
    assert res["ok"], res


@pytest.mark.parametrize("integrator", ["singlescatter", "raymarch",
                                        "pureraymarch", "hitmask"])
def test_integrators_on_card_match_cpu(cuda_device, integrator):
    """Each integrator at 16^2 on the card against the CPU
    (testing.CARD_CPU_BARS), drawing through K3 and calling no plain
    version."""
    render, kw = {
        "singlescatter": (render_single_scatter, dict(spp=4)),
        "raymarch": (render_raymarch_gaussians,
                     dict(step_size=0.02, env_samples=4)),
        "pureraymarch": (render_pure_raymarch,
                         dict(step_size=0.1, env_samples=2)),
        "hitmask": (render_hit_mask, {})}[integrator]
    cfg = RenderConfig(width=16, height=16, **kw)
    for cam in _cameras("cpu"):
        want = render(parse_gmm(SCENE24), cam, cfg, device="cpu")
        counters = (trng.wave_uniforms, trng.planes_uniforms,
                    trng.wave_uniforms_reference,
                    trng.planes_uniforms_reference)
        for fn in counters:
            fn.launches = 0
        stats = {}
        got = render(parse_gmm(SCENE24), cam, cfg, device=cuda_device,
                     stats=stats)
        assert [fn.launches for fn in counters] == [
            0, stats.get("k3_launches", 0), 0, 0]
        res = card_cpu_agreement(got, want, hitmask=integrator == "hitmask")
        assert res["ok"], (integrator, res)


def test_path_statistics_on_card_match_cpu(cuda_device):
    cfg = RenderConfig(width=32, height=32)
    cam = _cameras("cpu")[0]
    want = path_statistics(parse_gmm(SCENE24), cam, cfg, 512, device="cpu")
    got = path_statistics(parse_gmm(SCENE24), cam, cfg, 512,
                          device=cuda_device)
    assert got == pytest.approx(want, rel=1e-2)


# ---- the inverse renderer on the card -------------------------------------

# tests/test_inverse.py's 10-Gaussian scene
SCENE10 = random_gaussian_scene(10, seed=2, diameter=(0.2, 0.7))
K3_COUNTERS = (trng.planes_uniforms, trng.planes_uniforms_reference,
               trng.wave_uniforms, trng.wave_uniforms_reference)


def _fit_rays(device, w: int = 16):
    """(o, d, ids) through the pixel centres of a w^2 image, pinhole at
    (0,1,6) toward (0,1,0), FOV 45 degrees."""
    cam = PinholeCamera.create([0, 1, 6], [0, 1, 0], 0.25 * math.pi,
                               device=device)
    return tfit._pixel_rays(cam, w, w, torch.arange(w * w, dtype=torch.int32,
                                                    device=device))


def _k3_launches(fn):
    """(fn's result, launches of planes_uniforms, its plain version,
    wave_uniforms, its plain version)."""
    for c in K3_COUNTERS:
        c.launches = 0
    out = fn()
    torch.cuda.synchronize()
    return out, [c.launches for c in K3_COUNTERS]


@pytest.mark.parametrize("loss", ["l2", "l2_dual"])
def test_fit_loss_on_card_matches_cpu(cuda_device, loss):
    """fit_loss and its gradient (16^2, 2 bounces, spp 2) on the card
    against the CPU at testing.FIT_BARS, the parameters packed once on
    the CPU; on the card K3 launches once for each buffer and sample and
    no plain version runs."""
    params = parse_gmm(SCENE10).medium.pack_parameters()
    out = {}
    for dev in ("cpu", cuda_device):
        sc = parse_gmm(SCENE10, device=dev)
        o, d, ids = _fit_rays(dev)
        p = params.to(dev, copy=True).requires_grad_(True)

        def run():
            val = tfit.fit_loss(p, sc, o, d, ids,
                                torch.full((256, 3), 0.4, device=dev),
                                n_bounces=2, spp=2, loss=loss, seed=5)
            val.backward()
            return val

        out[str(dev)] = (*_k3_launches(run), p.grad)
    val, launches, grad = out[str(cuda_device)]
    assert launches == [4 if loss == "l2_dual" else 2, 0, 0, 0]
    res = fit_agreement(val, grad, out["cpu"][0], out["cpu"][2])
    assert res["ok"], res


def test_radiance_diff_on_card_matches_cpu(cuda_device):
    """multiscatter_radiance_diff at 32^2, 4 bounces, RR from bounce 2 on
    the card against the CPU (testing.CARD_CPU_BARS): one K3 launch draws
    every bounce, and no plain version runs."""
    imgs = {}
    for dev in ("cpu", cuda_device):
        sc = parse_gmm(SCENE10, device=dev)
        o, d, ids = _fit_rays(dev, 32)
        img, launches = _k3_launches(lambda: multiscatter_radiance_diff(
            sc, o, d, ids, None, n_bounces=4, sample=3, seed=9, rr_after=2))
        imgs[str(dev)] = img.cpu().numpy().reshape(32, 32, 3)
    assert launches == [1, 0, 0, 0]
    res = card_cpu_agreement(imgs[str(cuda_device)], imgs["cpu"])
    assert res["ok"], res


def test_diff_draws_are_keyed_by_bounce(cuda_device):
    """The estimator's draws on the card, [9, bounces, B] from one K3
    launch, equal the plain hash keyed by (pixel, sample, bounce j) for
    each bounce j, bit for bit."""
    ids = torch.arange(70_001, dtype=torch.int32)
    got = diff_uniforms(ids.to(cuda_device), 5, 4, 2**31 + 7).cpu()
    for j in range(4):
        want = torch.stack(trng.uniform_cols(ids, 5, j, 9, 2**31 + 7))
        assert torch.equal(got[:, j], want), j


def test_conditional_vjp_on_card_matches_central_differences(cuda_device):
    """The implicit-function VJP of solve_conditional_free_flight on the
    card against central differences of the solve
    (testing.SOLVE_FD_BARS), on the 10-Gaussian scene's 16^2 camera
    rays."""
    sc = parse_gmm(SCENE10, device=cuda_device)
    o, d, _ = _fit_rays(cuda_device)
    u = torch.from_numpy(np.random.default_rng(1).uniform(size=256)
                         .astype(np.float32)).to(cuda_device)
    res = solve_fd_agreement(sc, o, d, u)
    assert res["ok"], res


def test_codec_ignores_the_tf32_flag(cuda_device):
    """pack_parameters and from_parameters sum their products
    elementwise, so a caller's TF32 matmul setting changes no bit."""
    p = parse_gmm(random_gaussian_scene(250, seed=0)).medium \
        .pack_parameters().to(cuda_device)
    flags = (torch.backends.cuda.matmul.allow_tf32,
             torch.get_float32_matmul_precision())
    outs = []
    try:
        for tf32, prec in ((False, "highest"), (True, "high")):
            torch.backends.cuda.matmul.allow_tf32 = tf32
            torch.set_float32_matmul_precision(prec)
            m = GaussianMixture.from_parameters(p)
            outs.append([m.cov, m.inv_cov, m.norm, m.eigvecs,
                         m.pack_parameters()])
    finally:
        torch.backends.cuda.matmul.allow_tf32 = flags[0]
        torch.set_float32_matmul_precision(flags[1])
    for g, w in zip(*outs):
        assert torch.equal(g, w)


def test_cli_fit_on_card(cuda_device, tmp_path):
    """`cli fit` on the card, 3 iterations at 32^2 with snapshots: four K3
    launches an iteration (2 buffers x spp 2), the megakernel for the
    snapshots and the final render, no plain version; losses finite."""
    scene = tmp_path / "scene.txt"
    scene.write_text(SCENE10)
    target = tmp_path / "target.ppm"
    write_ppm(str(target), np.full((32, 32, 3), 0.5, np.float32))
    counters = K3_COUNTERS + (tmt.mega_call, tmt.mega_reference)
    for c in counters:
        c.launches = 0
    res = cli.main(["fit", str(scene), "--target", str(target), "-o",
                    str(tmp_path / "fit"), "--iters", "3", "--save-every",
                    "1", "--bounces", "2", "--spp", "4", "--final-spp", "16",
                    "--snapshots"])
    launches = [c.launches for c in counters]
    assert launches[:4] == [12, 0, 0, 0] and launches[4] >= 4 \
        and launches[5] == 0, launches
    assert all(np.isfinite(v) for _, v in res["losses"])
    assert read_ppm(res["paths"][-1]).shape == (32, 32, 3)


# ---- media and animation on the card --------------------------------------

SPHERES16 = random_sphere_scene(16, seed=0)


def _voxel_scene(device, res: int = 24):
    """random_gaussian_scene(250, 0), parsed on the CPU (eigh on the card
    rounds apart), baked at res^3 on ``device``."""
    sc = parse_gmm(random_gaussian_scene(250, seed=0)).to(device)
    return sc.with_medium(VoxelGrid.from_gaussians(sc.medium, res=res))


@pytest.mark.parametrize("case", ["spheres raymarch", "spheres pure",
                                  "voxels pure", "spheres hitmask",
                                  "voxels hitmask"])
def test_media_on_card_match_cpu(cuda_device, case):
    """The sphere marcher, the pure marcher (spheres, a 24^3 bake) and the
    hit mask at 16^2 on the card against the CPU (testing.CARD_CPU_BARS),
    K3 launched once a march step and no plain version called."""
    medium, integrator = case.split()
    render, kw = {
        "raymarch": (render_raymarch_spheres,
                     dict(step_size=0.02, env_samples=4)),
        "pure": (render_pure_raymarch, dict(step_size=0.1, env_samples=2)),
        "hitmask": (render_hit_mask, {})}[integrator]
    cfg = RenderConfig(width=16, height=16, **kw)
    cam = _cameras("cpu")[0]

    def scene(device):
        return (parse_smm(SPHERES16, device=device) if medium == "spheres"
                else _voxel_scene(device))

    want = render(scene("cpu"), cam, cfg, device="cpu")
    counters = (trng.wave_uniforms, trng.planes_uniforms,
                trng.wave_uniforms_reference, trng.planes_uniforms_reference)
    sc = scene(cuda_device)
    for fn in counters:
        fn.launches = 0
    stats = {}
    got = render(sc, cam, cfg, device=cuda_device, stats=stats)
    assert [fn.launches for fn in counters] == [
        0, stats.get("k3_launches", 0), 0, 0]
    assert integrator == "hitmask" or stats["k3_launches"] > 0
    res = card_cpu_agreement(got, want, hitmask=integrator == "hitmask")
    assert res["ok"], (case, res)


def test_voxel_bake_on_card_matches_cpu(cuda_device):
    """VoxelGrid.from_gaussians of the 250-Gaussian scene at 48^3 on the
    card against the CPU: testing.BAKE_BARS."""
    card = _voxel_scene(cuda_device, 48).medium
    cpu = _voxel_scene("cpu", 48).medium
    assert card.sigma_t.device.type == "cuda"
    res = bake_agreement(card, cpu)
    assert res["ok"], res


def test_native_gif_encoder_builds(tmp_path):
    """The GIF encoder builds from csrc/gif_native.cpp with c++ on the
    card's machine and writes the file (last_backend 'native'): GIF89a,
    the screen size, one image a frame, the trailer."""
    r = np.random.default_rng(0)
    frames = [r.uniform(0, 1, (24, 40, 3)).astype(np.float32)
              for _ in range(3)]
    path = tmp_path / "a.gif"
    gif.write_gif(str(path), frames, delay_cs=4)
    assert gif.last_backend == "native"
    assert gif_structure(path.read_bytes()) == dict(
        signature=True, width=40, height=24, frames=3, trailer=True)


def test_cli_animate_multiscatter_on_card(cuda_device, tmp_path):
    """`cli animate --integrator multiscatter` of a Gaussian scene at 32^2,
    3 frames, spp 4: the megakernel once a frame (one chunk), no plain
    version, K3 inside K1 only; the native encoder writes 3 frames."""
    scene = tmp_path / "scene.txt"
    scene.write_text(SCENE24)
    counters = (tmt.mega_call, tmt.mega_reference) + K3_COUNTERS
    for c in counters:
        c.launches = 0
    res = cli.main(["animate", str(scene), "-o", str(tmp_path / "a.gif"),
                    "--integrator", "multiscatter", "--width", "32",
                    "--height", "32", "--frames", "3", "--spp", "4"])
    assert [c.launches for c in counters] == [3, 0, 0, 0, 0, 0]
    assert res["backend"] == "native" and res["frames"] == 3
    assert gif_structure((tmp_path / "a.gif").read_bytes()) == dict(
        signature=True, width=32, height=32, frames=3, trailer=True)


# ---- the paths at the cells' sizes, through the CLI ------------------------

# case: (random_gaussian_scene's keys, size, spp, CLI arguments, the path,
# the kernels it launches)
AT_SIZE = {
    "mega": (dict(n=250, seed=0), 1024, 64, [], "mega", ("mega_call",)),
    "grid": (dict(n=10_000, seed=0), 512, 16, [], "grid",
             ("wave_uniforms", "span_tau_pass", "solve_pass")),
    "big": (dict(n=10_000, seed=0), 512, 16, ["--engine", "dense"], "big",
            ("wave_pre", "wave_post", "big_stage1", "big_nee")),
    "fallback": (dict(n=8000, seed=0, diameter=(2.0, 4.0)), 128, 4, [],
                 "big", ("wave_pre", "wave_post", "big_stage1", "big_nee")),
}


@pytest.mark.parametrize("case", sorted(AT_SIZE))
def test_cli_render_at_size(cuda_device, tmp_path, case):
    """`cli render` through each path at the size it serves: the headline
    (250 Gaussians, 1024^2 spp 64) through K1; the 10k scene at 512^2 spp
    16 through the grid under engine auto and through the big-N kernels
    under --engine dense; the S_CAP_MAX fallback scene (8,000 Gaussians of
    diameter 2-4, 128^2 spp 4), whose grid engine auto refuses, through
    the big-N kernels.  Each: the image finite and not constant, the
    path's kernels launched (K3 once a grid iteration, K8's two launches
    once a dense-wavefront iteration), no plain version called, and a
    second render's PPM the same bytes."""
    kw, size, spp, args, path, kernels = AT_SIZE[case]
    scene = tmp_path / "scene.txt"
    scene.write_text(random_gaussian_scene(**kw))
    counters = checks.counted_kernels()
    ppm = []
    for k in range(2):
        for fn in counters:
            fn.launches = 0
        out = tmp_path / f"out{k}.ppm"
        stats = cli.main(["render", str(scene), "-o", str(out), "--width",
                          str(size), "--height", str(size), "--spp",
                          str(spp), "--stats", "--device", str(cuda_device)]
                         + args)
        ppm.append(out.read_bytes())
        launches = {fn.__name__: fn.launches for fn in counters}
        assert stats["kernel"] == path
        assert all(launches[k] for k in kernels), launches
        assert not any(v for k, v in launches.items()
                       if k.endswith("_reference")), launches
        if path == "grid":
            assert launches["wave_uniforms"] == stats["iterations"]
        if "wave_pre" in kernels:
            assert launches["wave_pre"] == launches["wave_post"] \
                == stats["iterations"] + stats["spare_iterations"]
    img = read_ppm(str(out))
    assert img.shape == (size, size, 3) and img.std() > 0
    assert ppm[0] == ppm[1]


def test_cli_trace_on_card(cuda_device, tmp_path):
    """`cli render --trace DIR --stats` of the headline's scene at 256^2
    spp 4, in a process of its own (late in a long process torch.profiler
    may record none of a short run's launches): the Chrome trace holds
    K1's kernel and the render's spans, and the report prints the chunk
    and render_multiscatter spans."""
    scene = tmp_path / "scene.txt"
    scene.write_text(random_gaussian_scene(250, seed=0))
    run = subprocess.run(
        [sys.executable, "-m", "gvr_tpu_torch.cli", "render", str(scene),
         "-o", str(tmp_path / "o.ppm"), "--width", "256", "--height", "256",
         "--spp", "4", "--trace", str(tmp_path / "trace"), "--stats",
         "--device", "cuda"], cwd=ROOT, capture_output=True, text=True,
        env=dict(os.environ, PYTHONPATH=str(ROOT)), timeout=600)
    assert run.returncode == 0, run.stderr[-4000:]
    trace = json.loads((tmp_path / "trace" / TRACE_FILE).read_text())
    names = {e.get("name", "") for e in trace["traceEvents"]}
    # a kernel's event is named by its demangled signature
    # ("void gvr::mega_kernel<false>(...)")
    assert any("gvr::mega_kernel" in n for n in names), \
        sorted(n for n in names if "gvr" in n or "kernel" in n)[:20]
    assert {"render.prepare", "chunk", "render.readback"} <= names
    assert "[gvr] chunk:" in run.stdout
    assert "[gvr] render_multiscatter:" in run.stdout


def test_bounce_kernel_on_the_step_paths_rays(cuda_device, monkeypatch):
    """K2 on its own inputs on the step path: the first iteration of the
    headline's chunk 9 (65,536 camera rays through the medium) and its
    first with at most 1,024 live lanes, against the plain version at
    PATH_BOUNCE_BARS (camera rays that graze a Gaussian's R_CUT clip part
    float32 from float64: tests/test_torch_step.py)."""
    sc = parse_gmm(random_gaussian_scene(250, seed=0), device=cuda_device)
    cam = PinholeCamera.create([0, 1, 6], [0, 1, 0], math.radians(45.0),
                               device=cuda_device)
    cfg = RenderConfig(width=1024, height=1024, spp=64, wavefront="step")
    ids = tms.tile_ids(1024, 1024, cuda_device)[9 * 65536:10 * 65536]
    picked, real = {}, tms.bounce_step

    def record(*args):
        key = "tail" if picked else "full"
        if key not in picked and (key == "full" or args[1].shape[0] <= 1024):
            picked[key] = tuple(a.clone() if torch.is_tensor(a) else a
                                for a in args)
        return real(*args)

    monkeypatch.setattr(tms, "bounce_step", record)
    tms.wavefront_pixels_step(sc, cam, cfg, ids)
    assert set(picked) == {"full", "tail"}
    assert picked["full"][1].shape[0] == 65536
    for key, args in picked.items():
        res = bounce_agreement(tpt.bounce_step(*args),
                               tpt.bounce_core_reference(*args),
                               PATH_BOUNCE_BARS)
        assert res["ok"], (key, res)


# ---- the parallel layer: two gloo ranks that share the card ----------------

# label: (scene, RenderConfig's fields, the kernels each rank launches)
DP_CARD = {
    "mega": ("250", dict(width=1024, height=1024, spp=64), ("mega_call",)),
    "step": ("250", dict(width=512, height=512, spp=16, wavefront="step"),
             ("wave_pre", "wave_post", "bounce_step")),
    "grid": ("10k", dict(width=512, height=512, spp=16),
             ("wave_uniforms", "span_tau_pass", "solve_pass")),
    "big": ("10k", dict(width=256, height=256, spp=4, engine="dense"),
            ("wave_pre", "wave_post", "big_stage1", "big_nee")),
}
TP_CARD = dict(width=128, height=128, spp=4, max_bounces=3)
# the data-parallel fit against one process: tests/test_gauss_sharded.py's
# trajectory bars (losses within rtol 1e-4 beyond the log's 5 decimals,
# parameters within 1e-3 |p| + 1e-5) after each of FIT_HELD iterations: the
# two ranks sum the batch's gradient in another order than one process,
# and Adam's normalised step parts the trajectories after that
FIT_HELD, FIT_LOSS_RTOL, FIT_RTOL, FIT_ATOL = 2, 1e-4, 1e-3, 1e-5


def _arrays(sc) -> dict:
    """A Scene as numpy arrays, which every rank and every reference
    start from."""
    out = {k: getattr(sc.medium, k).detach().cpu().numpy()
           for k in MIXTURE_FIELDS}
    out.update({k: getattr(sc, k).cpu().numpy() for k in SCENE_FIELDS})
    return out


@pytest.fixture(scope="module")
def card_ranks():
    """(inputs, each rank's result) of ``parallel.checks.card_suite`` on
    two gloo ranks that share the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (torch.cuda.is_available() is false)")
    dev = torch.device("cuda", 0)
    scenes = {"250": _arrays(parse_gmm(random_gaussian_scene(250, seed=0))),
              "10k": _arrays(parse_gmm(random_gaussian_scene(10_000,
                                                             seed=0))),
              "10": _arrays(parse_gmm(SCENE10))}
    true = parse_gmm(random_gaussian_scene(250, seed=0))
    p = true.medium.pack_parameters().numpy()
    p = p + np.random.default_rng(7).normal(0, 0.1, p.shape) \
        .astype(np.float32)
    target = render_multiscatter(
        scene_from_numpy(scenes["250"], dev), checks.camera(dev),
        RenderConfig(width=128, height=128, spp=1024), device=dev)
    inp = dict(dp=[(label, scenes[key], kw)
                   for label, (key, kw, _) in DP_CARD.items()],
               tp_scene=scenes["250"], tp_cfg=TP_CARD,
               fit_scene=scenes["10"],
               fit_params=parse_gmm(SCENE10).medium.pack_parameters().numpy(),
               fit_seed=5,
               fit_init=_arrays(true.with_medium(
                   GaussianMixture.from_parameters(torch.from_numpy(p)))),
               fit_target=target, fit_iters=FIT_HELD, fit_batch=4096)
    ranks = spawn(checks.card_suite, 2, inp, device="cuda", timeout=300.0,
                  deadline=900.0)
    return inp, ranks


@pytest.mark.parametrize("label", sorted(DP_CARD))
def test_dp_render_on_card_is_one_process(cuda_device, card_ranks, label):
    """render_multiscatter over two ranks that share the card, through
    each engine's path: the assembled image equal to the one-process
    image bit for bit, and each rank launched its path's kernels (K2 and
    K8 once an iteration) and no plain version."""
    inp, ranks = card_ranks
    key, kw, kernels = DP_CARD[label]
    scene = dict((lb, arrays) for lb, arrays, _ in inp["dp"])[label]
    cfg = RenderConfig(**kw)
    one = render_multiscatter(scene_from_numpy(scene, cuda_device),
                              checks.camera(cuda_device), cfg,
                              device=cuda_device)
    assert np.array_equal(ranks[0]["dp"][label]["image"], one)
    for r in ranks:
        st, launches = r["dp"][label]["stats"], r["dp"][label]["launches"]
        assert st["kernel"] == label and st["shards"] == 2
        assert all(launches[k] for k in kernels), launches
        assert not any(v for k, v in launches.items()
                       if k.endswith("_reference")), launches
        for k in ("bounce_step", "wave_pre", "wave_post"):
            assert launches[k] in (0, st["iterations"]
                                   + st["spare_iterations"]), (k, launches)


def test_tp_on_card_matches_one_device(cuda_device, card_ranks):
    """render_multiscatter_tp over a (1 rays x 2 gauss) mesh on the card
    against the one-device sample loop (mc_camera_rays and
    multiscatter_radiance) at TP_BARS, and fit_value_and_grad_tp's loss
    and gathered gradient against fit_loss and its backward at FIT_BARS,
    the same on both ranks."""
    inp, ranks = card_ranks
    sc = scene_from_numpy(inp["tp_scene"], cuda_device)
    cam = checks.camera(cuda_device)
    cfg = RenderConfig(**inp["tp_cfg"])
    ids = torch.arange(cfg.width * cfg.height, dtype=torch.int32,
                       device=cuda_device)
    acc = torch.zeros((ids.shape[0], 3), device=cuda_device)
    for s in range(cfg.spp):
        o, d, rid = tms.mc_camera_rays(sc, cam, cfg, ids, s)
        acc = acc + tms.multiscatter_radiance(sc, o, d, rid, cfg, sample=s)
    res = tp_agreement(ranks[0]["tp_render"], (acc / cfg.spp).cpu().numpy())
    assert res["ok"], res
    sc10 = scene_from_numpy(inp["fit_scene"], cuda_device)
    o, d, ids = checks.pixel_rays(16, 16, cuda_device)
    p = params_from_numpy(inp["fit_params"], cuda_device) \
        .requires_grad_(True)
    val = tfit.fit_loss(p, sc10, o, d, ids,
                        torch.full((256, 3), 0.4, device=cuda_device),
                        n_bounces=2, seed=inp["fit_seed"])
    val.backward()
    tp = [r["tp_fit"] for r in ranks]
    res = fit_agreement(tp[0]["loss"], tp[0]["grad"], val, p.grad)
    assert res["ok"], res
    assert np.array_equal(tp[0]["grad"], tp[1]["grad"])


def test_dp_fit_on_card_matches_one_process(cuda_device, card_ranks):
    """fit_gaussians over two ranks that share the card, from the
    headline scene's parameters perturbed by N(0, 0.1) toward its 128^2
    spp 1024 render, against one process: the losses and parameters after
    each of the first FIT_HELD iterations within the trajectory bars, and
    the same parameters on both ranks."""
    inp, ranks = card_ranks
    one = checks.logged_fit(scene_from_numpy(inp["fit_init"], cuda_device),
                            inp["fit_target"], FIT_HELD, inp["fit_batch"])
    fit = ranks[0]["fit"]
    assert len(fit["params"]) == len(one["params"]) == FIT_HELD
    for a, b in zip(fit["params"], one["params"]):
        assert np.max(np.abs(a - b) - FIT_RTOL * np.abs(b)) <= FIT_ATOL
    for a, b in zip(fit["losses"], one["losses"]):
        assert max(abs(a - b) - 1e-5, 0.0) / abs(b) <= FIT_LOSS_RTOL
    assert all(np.array_equal(a, b) for a, b in zip(
        fit["params"], ranks[1]["fit"]["params"]))


def test_torchrun_cli_render_over_nccl(cuda_device, tmp_path):
    """`torchrun --nproc-per-node 1 -m gvr_tpu_torch.cli render` of the
    headline's scene at 256^2 spp 16 joins a one-rank job over NCCL and
    writes the same PPM bytes as a render in this process."""
    scene = tmp_path / "s.txt"
    scene.write_text(random_gaussian_scene(250, seed=0))
    args = ["render", str(scene), "--width", "256", "--height", "256",
            "--spp", "16"]
    run = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "1", "-m", "gvr_tpu_torch.cli"] + args
        + ["-o", str(tmp_path / "run.ppm"), "--device", "cuda"], cwd=ROOT,
        env=dict(os.environ, PYTHONPATH=str(ROOT)), capture_output=True,
        text=True, timeout=600)
    assert run.returncode == 0, run.stderr[-4000:]
    banner = [x for x in run.stdout.splitlines() if "[gvr] rank" in x]
    assert banner and "nccl" in banner[0], run.stdout
    cli.main(args + ["-o", str(tmp_path / "one.ppm"), "--device",
                     str(cuda_device)])
    assert (tmp_path / "run.ppm").read_bytes() \
        == (tmp_path / "one.ppm").read_bytes()
