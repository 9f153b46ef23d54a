"""The port's grid engine on the CPU against gvr_tpu's: the build, the DDA,
the plain versions of K6 (span tau) and K7 (cell solve), the pooled grid
wavefront, chunk invariance and the engine dispatch.

The scene and rays are tests/test_grid.py's fixture: 120 Gaussians of
diameter 0.05-0.9 (supports over many cells) and 256 rays from seed 7.  The
JAX side runs its Pallas kernels in interpret mode, as test_grid.py does,
and its grid crosses over as numpy arrays (scene/convert.grid_from_numpy),
so both packages trace the same table.  JAX's kernels use an A&S erf that
differs from torch.erf by ~1.5e-7, and the two packages sum in other
orders; each tolerance below says what it allows for."""

import dataclasses
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_common import box_rays, port_camera, port_scene
from gvr_tpu.accel.grid import build_grid as jax_build_grid
from gvr_tpu.accel.grid import dda_crossings as jax_dda
from gvr_tpu.cameras import PinholeCamera as JPinhole
from gvr_tpu.config import RenderConfig as JConfig
from gvr_tpu.config import Solver as JSolver
from gvr_tpu.integrators import gridscatter as jgs
from gvr_tpu.scene.generators import random_gaussian_scene
from gvr_tpu.scene.scene import parse_gmm as jax_parse_gmm
from gvr_tpu_torch import cli
from gvr_tpu_torch.accel import grid as tgrid
from gvr_tpu_torch.config import RenderConfig, Solver
from gvr_tpu_torch.integrators import gridscatter as tgs
from gvr_tpu_torch.integrators.multiscatter import (GRID_MIN_N, engine_for,
                                                    render_multiscatter)
from gvr_tpu_torch.kernels import gridtrace as tgt
from gvr_tpu_torch.kernels.pathtrace import may_cross_reference
from gvr_tpu_torch.scene.convert import GRID_FIELDS, grid_from_numpy
from gvr_tpu_torch.scene.gaussians import GaussianMixture
from gvr_tpu_torch.scene.scene import parse_gmm
from gvr_tpu_torch.testing import solve_agreement, span_tau_agreement

TEXT = random_gaussian_scene(120, seed=3, diameter=(0.05, 0.9))
N_RAYS = 256


@pytest.fixture(scope="module")
def jscene():
    return jax_parse_gmm(TEXT)


@pytest.fixture(scope="module")
def jgrid(jscene):
    return jax_build_grid(jscene.medium)


@pytest.fixture(scope="module")
def grid(jgrid):
    return grid_from_numpy({k: np.asarray(getattr(jgrid, k))
                            for k in GRID_FIELDS})


@pytest.fixture(scope="module")
def rays():
    rng = np.random.default_rng(7)
    o = rng.uniform([-2.5, -1.0, -2.5], [2.5, 3.0, 2.5], (N_RAYS, 3))
    d = rng.normal(size=(N_RAYS, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return o.astype(np.float32), d.astype(np.float32)


TMAX = np.linspace(0.3, 6.0, N_RAYS).astype(np.float32)


def _both(a):
    """(jax array, torch tensor) of one numpy array."""
    return jnp.asarray(a), torch.from_numpy(np.ascontiguousarray(a))


def test_aabbs_equal_jax(jscene):
    """The port sums the half-extent as XLA's fused multiply-add chain
    does, so the boxes agree to the last bit but for XLA's CPU sqrt, which
    is not correctly rounded (1 ulp off on one of the 360 eigenvalues
    here): within 2 ulp of the largest coordinate."""
    want = [np.asarray(a) for a in jscene.medium.aabbs()]
    got = [a.numpy() for a in port_scene(jscene).medium.aabbs()]
    for g, w in zip(got, want):
        assert (g != w).mean() < 0.01
        np.testing.assert_allclose(g, w, rtol=0,
                                   atol=2 * np.spacing(np.abs(w).max()))


def test_build_grid_equals_jax(jscene, jgrid):
    """The port's own build from the carried-over mixture: the same side,
    s_cap, counts, entry order and geometry; rows exact except q = inv_cov
    @ mean (columns 6-8), a 3-term dot that XLA fuses into multiply-adds,
    within 2 ulp of the sum of its products' magnitudes (measured 1.5)."""
    g = tgrid.build_grid(port_scene(jscene).medium)
    assert g.side == jgrid.side and g.s_cap == jgrid.s_cap
    assert g.n_entries == jgrid.n_entries
    assert np.array_equal(g.cell_count.numpy(), np.asarray(jgrid.cell_gcnt))
    assert np.array_equal(g.cell_first.numpy(),
                          np.asarray(jgrid.cell_gfirst))
    for k in ("lo", "cell", "inv_cell"):
        assert np.array_equal(getattr(g, k).numpy(),
                              np.asarray(getattr(jgrid, k)))
    want = np.asarray(jgrid.table).reshape(-1, 16)[:g.table.shape[0]]
    got = g.table.numpy()
    exact = [c for c in range(16) if c not in (6, 7, 8)]
    assert np.array_equal(got[:, exact], want[:, exact])
    ic = np.abs(np.asarray(jscene.medium.inv_cov, np.float64))
    mean = np.abs(np.asarray(jscene.medium.mean, np.float64))
    # each entry's Gaussian, by its mean (columns 13-15 are exact copies)
    gid = np.argmin(np.abs(want[:g.n_entries, None, 13:16]
                           - np.asarray(jscene.medium.mean)[None]).sum(-1),
                    axis=1)
    scale = (ic * mean[:, None, :]).sum(-1)[gid]           # [E, 3]
    assert (np.abs(got[:g.n_entries, 6:9] - want[:g.n_entries, 6:9])
            <= 2 * np.spacing(scale.astype(np.float32))).all()


@pytest.mark.parametrize("with_tmax", [False, True])
def test_dda_crossings_equal_jax(jgrid, grid, rays, with_tmax):
    """The same cells; t within 1e-6 (the same float32 plane times; only
    the sort differs, which moves no value)."""
    (jo, to), (jd, td) = _both(rays[0]), _both(rays[1])
    jt, tt = _both(TMAX) if with_tmax else (None, None)
    want = [np.asarray(a) for a in jax_dda(jgrid, jo, jd, jt)]
    got = [a.numpy() for a in tgrid.dda_crossings(grid, to, td, tt)]
    assert got[0].dtype == np.int32 and got[0].shape == want[0].shape
    assert np.array_equal(got[0], want[0])
    assert (got[0] >= 0).sum() > N_RAYS
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-6)


def test_dda_cells_are_unique_per_ray(grid, rays):
    """K6 integrates a whole cell crossing from the id alone, so a ray
    must never list one cell twice (the run merge)."""
    cells, t_in, t_out = tgrid.dda_crossings(
        grid, torch.from_numpy(rays[0]), torch.from_numpy(rays[1]))
    for r in range(N_RAYS):
        v = cells[r][cells[r] >= 0]
        assert v.unique().numel() == v.numel()
    valid = cells >= 0
    assert bool((t_out[valid] > t_in[valid]).all())


@pytest.mark.parametrize("with_tmax", [False, True])
def test_span_tau_matches_jax(jgrid, grid, rays, with_tmax):
    """K6's plain version per crossing against the Pallas kernel
    (interpret): rtol 1e-4 / atol 1e-5 for the A&S erf and the sum
    order."""
    (jo, to), (jd, td) = _both(rays[0]), _both(rays[1])
    jt, tt = _both(TMAX) if with_tmax else (None, None)
    want = [np.asarray(a) for a in jgs.grid_tau_crossings(
        jgrid, jo, jd, jt, True)]
    tgt.span_tau_reference.launches = 0
    got = [a.numpy() for a in tgs.grid_tau_crossings(grid, to, td, tt)]
    assert tgt.span_tau_reference.launches == 1
    assert np.array_equal(got[1], want[1])
    assert (want[0] > 0).sum() > 150
    np.testing.assert_allclose(got[0], want[0], rtol=1e-4, atol=1e-5)


def test_grid_transmittance_matches_jax(jgrid, grid, rays):
    (jo, to), (jd, td) = _both(rays[0]), _both(rays[1])
    jt, tt = _both(TMAX)
    want = np.asarray(jgs.grid_transmittance(jgrid, jo, jd, jt, True))
    got = tgs.grid_transmittance(grid, to, td, tt).numpy()
    assert ((want > 0.01) & (want < 0.99)).sum() > 20
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-6)


def test_grid_free_flight_matches_jax(jgrid, grid, rays):
    """K7's plain version through the critical-crossing search, against
    the Pallas solve (interpret), u from seed 11: scatter decisions agree
    on >= 99.5 % of rays (a target within rounding of the total can flip);
    where both scatter, t within rtol 1e-3 / atol 1e-4; albedo where t
    matches, within 1e-4 (the same entries, other erf)."""
    (jo, to), (jd, td) = _both(rays[0]), _both(rays[1])
    u = np.random.default_rng(11).uniform(0.01, 0.99, N_RAYS) \
        .astype(np.float32)
    ju, tu = _both(u)
    want = [np.asarray(a) for a in jgs.grid_free_flight(jgrid, jo, jd, ju,
                                                        6, True)]
    tgt.solve_reference.launches = 0
    got = [a.numpy() for a in tgs.grid_free_flight(grid, to, td, tu, 6)]
    assert tgt.solve_reference.launches == 1
    assert (got[1] == want[1]).mean() >= 0.995
    both = got[1] & want[1]
    assert both.sum() > 30
    close = np.isclose(got[0], want[0], rtol=1e-3, atol=1e-4)
    assert close[both].all()
    np.testing.assert_allclose(got[2][both & close], want[2][both & close],
                               atol=1e-4)
    np.testing.assert_allclose(got[3], want[3], rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("kernel", ["span_tau", "solve"])
def test_kernel_bars_admit_float64_rounding(grid, rays, kernel):
    """testing.K6_BARS and K7_BARS, which hold each kernel against its plain
    version on the card, admit the plain version in float32 against itself
    in float64 on the same float32 crossings (u from seed 11): the bars
    are no tighter than float32 rounding of the same math."""
    g64 = dataclasses.replace(grid, table=grid.table.double(),
                              lo=grid.lo.double(), cell=grid.cell.double(),
                              inv_cell=grid.inv_cell.double())
    o, d = (torch.from_numpy(a) for a in rays)
    if kernel == "span_tau":
        tmax = torch.from_numpy(TMAX)
        cells, _, t_out = tgrid.dda_crossings(grid, o, d, tmax)
        got = tgt.span_tau_reference(grid, o, d, tmax, cells)
        want = tgt.span_tau_reference(g64, o.double(), d.double(),
                                      tmax.double(), cells).float()
        res = span_tau_agreement(got, want, grid, cells, t_out)
        assert res["slots"] > N_RAYS and res["ok"], res
    else:
        u = torch.from_numpy(np.random.default_rng(11).uniform(
            0.01, 0.99, N_RAYS).astype(np.float32))
        _, _, cells, t_in, t_out, resid = tgs.critical_crossing(
            grid, *tgs.grid_tau_crossings(grid, o, d), u)
        got = tgt.solve_reference(grid, o, d, t_in, t_out, resid, cells)
        want = [x.float() for x in tgt.solve_reference(
            g64, o.double(), d.double(), t_in.double(), t_out.double(),
            resid.double(), cells)]
        res = solve_agreement(got, want, cells)
        assert res["n"] > 30 and res["ok"], res


def test_crossed_entries_count_within_the_cell(grid, rays):
    """crossed_entries, which K7's bound counts: 0 for a ray without a live
    cell, at most its cell's entries, and a ray's count is that of its
    clip [t_in, t_out] alone (a one-ray call gives the same)."""
    o, d = (torch.from_numpy(a) for a in rays)
    u = torch.from_numpy(np.random.default_rng(11).uniform(
        0.01, 0.99, N_RAYS).astype(np.float32))
    _, _, cells, t_in, t_out, _ = tgs.critical_crossing(
        grid, *tgs.grid_tau_crossings(grid, o, d), u)
    n = tgt.crossed_entries(grid, o, d, t_in, t_out, cells)
    live = cells >= 0
    assert n.dtype == torch.int64 and not bool(n[~live].any())
    assert bool((n[live] <= grid.cell_count[cells[live].long()]).all())
    assert int((n > 0).sum()) > 30
    r = int(torch.argmax(n))
    one = tgt.crossed_entries(grid, o[r:r + 1], d[r:r + 1], t_in[r:r + 1],
                              t_out[r:r + 1], cells[r:r + 1])
    assert int(one[0]) == int(n[r])


def test_grid_free_flight_u_tau_zero_scatters_with_albedo(jgrid, grid,
                                                          rays):
    """u_tau == 0 (target 0): the 1e-12 target floor still lands the
    solve on an occupied cell, so every ray with medium ahead scatters
    with a real albedo, as in JAX (the albedo of the same Gaussians, within
    1e-4).  Where t lands is float32 rounding: tau(t) reaches 1e-12 at the
    medium entry, but erf(z(t)) - erf_lo stays 0 until it changes by an
    ulp, which for the widest Gaussians here is ~0.02 further on.  So t is
    held to >= 0 and to JAX's within 0.05."""
    (jo, to), (jd, td) = _both(rays[0]), _both(rays[1])
    zeros = np.zeros(N_RAYS, np.float32)
    want = [np.asarray(a) for a in jgs.grid_free_flight(
        jgrid, jo, jd, jnp.asarray(zeros), 6, True)]
    t_g, sc_g, alb_g, tau_tot = (a.numpy() for a in tgs.grid_free_flight(
        grid, to, td, torch.from_numpy(zeros), 6))
    sc = sc_g & (tau_tot > 1e-6)
    assert sc.sum() > 30 and (sc == (want[1] & (want[3] > 1e-6))).all()
    assert (alb_g[sc] > 0.0).all() and (t_g[sc] >= 0.0).all()
    np.testing.assert_allclose(alb_g[sc], want[2][sc], atol=1e-4)
    np.testing.assert_allclose(t_g[sc], want[0][sc], atol=0.05)


def test_pooled_grid_wavefront_matches_jax(jscene, jgrid, grid):
    """The pooled grid wavefront against gvr_tpu's (Pallas interpret) at
    16^2 spp 4: the same (pixel, sample, bounce) streams, so >= 99 % of
    pixels agree within 1e-3 and the mean |diff| is <= 1e-4 (a path whose
    scatter or RR test sits within rounding of its threshold moves its
    pixel by its radiance / spp)."""
    jcam = JPinhole.create([0, 1, 6], [0, 1, 0], 0.25 * math.pi)
    ids = np.arange(16 * 16, dtype=np.int32)
    want = np.asarray(jgs.wavefront_pixels_grid_pooled(
        jscene, jgrid, jcam, JConfig(width=16, height=16, spp=4,
                                     pallas="interpret",
                                     solver=JSolver.NEWTON),
        jnp.asarray(ids)))
    stats = {}
    got = tgs.wavefront_pixels_grid_pooled(
        port_scene(jscene), grid, port_camera(jcam),
        RenderConfig(width=16, height=16, spp=4, solver=Solver.NEWTON),
        torch.from_numpy(ids), stats).numpy()
    assert np.isfinite(got).all() and got.std() > 0
    diff = np.abs(got - want).max(axis=-1)
    assert (diff <= 1e-3).mean() >= 0.99
    assert np.abs(got - want).mean() <= 1e-4
    assert stats["iterations"] > 4 and stats["bounce_evals"] >= 16 * 16 * 4


def test_grid_render_is_chunk_invariant(grid):
    """Each sample adds into its own slot and a pixel sums its slots in
    sample order, so the image does not depend on the chunking."""
    sc = parse_gmm(TEXT)
    cam = port_camera(JPinhole.create([0, 1, 6], [0, 1, 0], 0.25 * math.pi))
    cfg = RenderConfig(width=16, height=16, spp=4, engine="grid",
                       solver=Solver.NEWTON)
    a_stats, b_stats = {}, {}
    a = render_multiscatter(sc, cam, cfg.replace(ray_chunk=64), "cpu",
                            stats=a_stats)
    b = render_multiscatter(sc, cam, cfg.replace(ray_chunk=1 << 16), "cpu",
                            stats=b_stats)
    assert a_stats["chunks"] == 4 and b_stats["chunks"] == 1
    assert a_stats["engine"] == b_stats["engine"] == "grid"
    np.testing.assert_allclose(a, b, atol=1e-6)


def test_grid_for_key_is_content_hash():
    """Swapping a mean's x and y keeps every sum but must rebuild."""
    gmm = parse_gmm(random_gaussian_scene(20, seed=5,
                                          diameter=(0.1, 0.5))).medium
    g1 = tgs.grid_for(gmm)
    assert tgs.grid_for(gmm) is g1
    mean2 = gmm.mean.clone()
    mean2[0, [0, 1]] = mean2[0, [1, 0]]
    gmm2 = GaussianMixture.from_covariances(mean2, gmm.cov, gmm.density,
                                            gmm.albedo)
    g2 = tgs.grid_for(gmm2)
    assert g2 is not g1
    assert not torch.equal(g1.table, g2.table)


@pytest.fixture(scope="module")
def mixture2500():
    return parse_gmm(random_gaussian_scene(2500, seed=0)).medium


def test_engine_for_auto_takes_the_grid_above_grid_min_n(mixture2500):
    assert mixture2500.n > GRID_MIN_N
    assert engine_for(RenderConfig(), mixture2500) == "grid"
    assert engine_for(RenderConfig(engine="grid"), mixture2500) == "grid"
    assert tgs.grid_for(mixture2500).s_cap <= tgrid.S_CAP_MAX


def test_engine_for_s_cap_fallback(mixture2500, monkeypatch):
    """A grid whose densest cell exceeds S_CAP_MAX sends 'auto' to the
    dense engine (the big-N kernels above MEGA_MAX_GAUSSIANS) and refuses
    engine='grid', as in the JAX package."""
    monkeypatch.setattr(tgrid, "S_CAP_MAX", 1)
    assert tgs.grid_for(mixture2500).s_cap > 1
    assert engine_for(RenderConfig(), mixture2500) == "dense"
    with pytest.raises(ValueError, match="S_CAP_MAX"):
        engine_for(RenderConfig(engine="grid"), mixture2500)


# K6's ray kinds: "nee past tmax" lists the cells of the whole line, so
# the slots beyond a segment's tmax have an empty clip
K6_KINDS = ["camera", "inside", "nee", "nee past tmax"]


def _k6_slots(grid, medium, kind):
    """K6's inputs for 48 rays of one kind (tests/_torch_common.box_rays;
    NEE segments with their tmax) on ``grid``: (o, d, tmax, cells)."""
    o, d, tmax = box_rays(medium, kind.split()[0], n=48, seed=5)
    if tmax is None:
        tmax = torch.full((o.shape[0],), 1e8)
    cells, _, _ = tgrid.dda_crossings(
        grid, o, d, None if kind == "nee past tmax" else tmax)
    return o, d, tmax, cells


def _slot_pairs(grid, o, d, tmax, cells):
    """Yield (ray, cell rows [count, 16], clip (t_in, t_out) [1, 1], ok
    [count]) for every slot with a non-empty cell, one slot at a time:
    the plain _quants over the cell's whole entry range."""
    for r, k in torch.nonzero(cells >= 0).tolist():
        cell = cells[r, k:k + 1].long()
        first, count = int(grid.cell_first[cell]), int(grid.cell_count[cell])
        if count == 0:
            continue
        rows = grid.table[first:first + count]
        ray = [v[r].reshape(1, 1) for v in (*o.T, *d.T)]
        t_in, t_out = tgt._cell_box_clip(grid, cell, ray,
                                         tmax[r].reshape(1, 1))
        ok = tgt._quants(lambda f: rows[None, :, f], ray, t_in, t_out,
                         torch.ones((1, count), dtype=torch.bool))[-1][0]
        yield r, k, rows, (t_in, t_out), ok


@pytest.mark.parametrize("kind", K6_KINDS)
def test_span_work_counts_each_slot(mixture2500, kind):
    """gridtrace.span_work, which K6's bound counts, against a slot by slot
    count from the plain _quants on a grid above GRID_MIN_N: visited is
    the cell's entries where the slot's clip is not empty (0 for an empty
    slot, cell or clip), crossed its ok pairs."""
    grid = tgs.grid_for(mixture2500)
    o, d, tmax, cells = _k6_slots(grid, mixture2500, kind)
    visited, crossed = tgt.span_work(grid, o, d, tmax, cells)
    want_v = torch.zeros_like(visited)
    want_c = torch.zeros_like(crossed)
    for r, k, rows, (t_in, t_out), ok in _slot_pairs(grid, o, d, tmax,
                                                     cells):
        want_v[r, k] = rows.shape[0] if float(t_out) > float(t_in) else 0
        want_c[r, k] = int(ok.sum())
    assert torch.equal(visited, want_v) and torch.equal(crossed, want_c)
    assert int(crossed.sum()) > 0
    if kind == "nee past tmax":
        live = cells >= 0
        assert bool((visited[live] == 0).any())
    assert int(crossed.sum()) < 0.2 * int(visited.sum())


@pytest.mark.parametrize("kind", K6_KINDS)
def test_k6_pretest_passes_every_ok_pair(mixture2500, kind):
    """K6 runs the division-free pre-test (may_cross) ahead of interval():
    every pair the plain walk finds ok on a slot's clipped span passes
    may_cross_reference, for camera rays, rays from inside the medium and
    NEE segments with their tmax, on a grid above GRID_MIN_N; so the rows
    the pre-test skips add exactly 0."""
    grid = tgs.grid_for(mixture2500)
    o, d, tmax, cells = _k6_slots(grid, mixture2500, kind)
    n_ok = n_rows = n_passed = 0
    for r, _, rows, _, ok in _slot_pairs(grid, o, d, tmax, cells):
        passed = may_cross_reference(rows, o[r:r + 1], d[r:r + 1])[:, 0]
        assert not (ok & ~passed).any()
        n_ok += int(ok.sum())
        n_rows += rows.shape[0]
        n_passed += int(passed.sum())
    assert n_ok > 0 and n_passed < 0.2 * n_rows


def test_config_grid_defaults_match_jax():
    assert RenderConfig().grid_solver_iters == JConfig().grid_solver_iters
    assert RenderConfig(engine="grid").engine == "grid"


def test_cli_renders_with_the_grid(tmp_path, capsys):
    scene = tmp_path / "scene.txt"
    scene.write_text(TEXT)
    out = tmp_path / "out.ppm"
    stats = cli.main(["render", str(scene), "-o", str(out), "--width", "8",
                      "--height", "8", "--spp", "2", "--engine", "grid",
                      "--stats", "--device", "cpu"])
    assert stats["engine"] == "grid" and stats["iterations"] > 0
    assert stats["bounce_evals"] >= 8 * 8 * 2
    assert "engine grid" in capsys.readouterr().out
    assert out.stat().st_size > 0
