"""The port's big-N dense engine on the CPU against gvr_tpu's: the Morton
order, the transposed table, the chunk plan, the plain versions of K4
(box-culled bounce) and K5 (box-culled NEE) against
``bounce_step_pallas_big`` in interpret mode, the big-N wavefront against
``wavefront_pixels``, and the engine dispatch; and the port's own chunk
boxes and box test, which must never cull a chunk that holds a pair a ray
crosses.

Inputs are made with numpy from seeds and handed to both packages; the
JAX scene crosses over as numpy arrays, so both pack the same table.  JAX's
kernels use an A&S erf within 1.5e-7 of torch.erf and sum in other orders;
each tolerance says what it allows for."""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_common import box_rays, port_camera, port_scene, random_rays
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
from gvr_tpu_torch.integrators import multiscatter as tms
from gvr_tpu_torch.integrators.multiscatter import (engine_for,
                                                    render_multiscatter,
                                                    wavefront_pixels_big)
from gvr_tpu_torch.kernels import megatrace as tmt
from gvr_tpu_torch.kernels import pathtrace as tpt
from gvr_tpu_torch.kernels import pathtrace_big as tpb
from gvr_tpu_torch.scene.gaussians import GaussianMixture, morton_order
from gvr_tpu_torch.scene.scene import MORTON_MIN_N, parse_gmm
from gvr_tpu_torch.testing import (BIG_DENSE_BARS, big_agreement, big_loops,
                                   big_rays)

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
    """Per ray, the chunks and groups its box tests admit (the kernels'
    ballots): the admitted chunks include every chunk with a crossed pair,
    each admits at most its 8 groups, and a segment cut at tmax admits and
    crosses no more.  The CPU wrappers report the same admitted chunks and
    groups."""
    sc = parse_gmm(_text(2100))
    table, boxes = tpb.pack_rows(sc.medium), tpb.chunk_boxes(sc.medium)
    o, d, xi = (torch.from_numpy(a) for a in random_rays(256, seed=1))
    st = tpb.culling_stats(table, boxes, o, d)
    n_c = table.shape[0] // tpb.G
    assert all(v.shape == (256,) for v in st.values())
    assert (st["admitted"] <= n_c).all()
    assert (st["groups"] <= 8 * st["admitted"]).all()
    assert (st["admitted"] >= st["hit"]).all()
    assert (st["hit"] <= st["crossed"]).all() and int(st["crossed"].sum()) > 0
    assert int(st["admitted"].sum()) < 256 * n_c
    assert int(st["groups"].sum()) < 8 * int(st["admitted"].sum())
    tmax = torch.full((256,), 0.3)
    cut = tpb.culling_stats(table, boxes, o, d, tmax)
    assert (cut["admitted"] <= st["admitted"]).all()
    assert int(cut["admitted"].sum()) < int(st["admitted"].sum())
    assert (cut["crossed"] <= st["crossed"]).all()
    adm = torch.zeros((2, 256), dtype=torch.int32)
    s1 = tpb.big_stage1(table, o, d, xi, sc.lights(), boxes=boxes,
                        admitted=adm)
    assert torch.equal(adm.long(), torch.stack([st["admitted"],
                                                st["groups"]]))
    tpb.big_nee(table, s1, sc.env_color, boxes, adm)
    nee = tpb.culling_stats(table, boxes, s1[4:7].T, s1[7:10].T, s1[10])
    assert torch.equal(adm.long(), torch.stack([nee["admitted"],
                                                nee["groups"]]))


@pytest.mark.parametrize("n", [600, 2100])
def test_chunk_boxes_contain_every_aabb(n):
    """Each chunk's box, and each of its eight 32-row groups' boxes, holds
    every aabbs() box of its Gaussians and equals their union over its
    Gaussians only (2,100: the last chunk is 80 % padding rows, which
    would span [-3, 3]^3, and its last six groups have none, so their
    boxes are empty), widened by the stated margin, recomputed in float64
    with numpy from the eigen-decomposition; the pad columns are 0."""
    gmm = parse_gmm(_text(n)).medium
    boxes = tpb.chunk_boxes(gmm).numpy()
    n_c = -(-n // tpb.G)
    assert boxes.shape == (n_c, 9, tpb.BOX_COLS)
    assert (boxes[..., 3] == 0).all() and (boxes[..., 7] == 0).all()
    lo, hi = (x.numpy() for x in gmm.aabbs())
    ev = np.clip(gmm.eigvals.numpy().astype(np.float64), 0.0, None)
    half = (np.abs(gmm.eigvecs.numpy().astype(np.float64))
            * (3.0 * np.sqrt(ev))[:, None, :]).sum(-1)
    mean = gmm.mean.numpy().astype(np.float64)
    for k, rows in ((0, tpb.G), (1, tpb.GROUP)):
        flat = boxes[:, 0] if k == 0 else boxes[:, 1:].reshape(-1, 8)
        block = np.arange(n) // rows
        assert (flat[block, 0:3] <= lo).all()
        assert (flat[block, 4:7] >= hi).all()
        for j in range(flat.shape[0]):
            sl = slice(j * rows, min(n, (j + 1) * rows))
            if sl.start >= n:
                assert (flat[j, 0:3] == tpb.EMPTY_BOX).all()
                assert (flat[j, 4:7] == -tpb.EMPTY_BOX).all()
                continue
            b_lo, b_hi = (mean - half)[sl].min(0), (mean + half)[sl].max(0)
            margin = (tpb.BOX_REL * (b_hi - b_lo).max() + tpb.BOX_ABS
                      * max(1.0, np.abs(b_lo).max(), np.abs(b_hi).max()))
            np.testing.assert_allclose(flat[j, 0:3], b_lo - margin,
                                       atol=1e-5)
            np.testing.assert_allclose(flat[j, 4:7], b_hi + margin,
                                       atol=1e-5)


def test_empty_chunk_box_is_missed():
    """A mixture without Gaussians packs one chunk of padding; its boxes
    are empty and every ray misses them, also rays along an axis."""
    gmm = GaussianMixture.from_covariances(
        np.zeros((0, 3)), np.zeros((0, 3, 3)), np.zeros(0), np.zeros(0))
    boxes = tpb.chunk_boxes(gmm)
    assert boxes.shape == (1, 9, 8)
    assert (boxes[..., 0:3] > boxes[..., 4:7]).all()
    o, d, _ = (torch.from_numpy(a) for a in random_rays(64, seed=5))
    d[:8] = torch.eye(3).repeat(3, 1)[:8]
    flat = boxes.view(-1, 8)
    assert not tpb.chunk_box_hits_reference(flat, o, d).any()
    assert not tpb.chunk_box_hits_reference(
        flat, torch.zeros((1, 3)), torch.tensor([[0.0, 0.0, 1.0]])).any()


# test_pallas_kernels' 2,100-Gaussian scene, and one whose Gaussians are as
# large as the S_CAP_MAX fallback scene's (diameter 2-4, every ray crossing
# all of them)
BOX_SCENES = {2100: dict(seed=0), 2300: dict(seed=0, diameter=(2.0, 4.0))}


def _crossed(table, o, d, tmax=None):
    """[N, B] bool: the pairs a ray crosses by ``_interval`` (a NEE
    segment: those that start before tmax), over chunks of 256 rays."""
    col = lambda f: table[:, f:f + 1]
    out = []
    for s in range(0, o.shape[0], 256):
        sl = slice(s, s + 256)
        ray = [v[sl, k][None, :] for v in (o, d) for k in range(3)]
        t0, t1, _, ok = tpt._interval(col, *ray, *tpt._coeffs(col, *ray))
        if tmax is not None:
            ok = ok & (torch.minimum(t1, tmax[sl][None, :]) > t0)
        out.append(ok)
    return torch.cat(out, dim=1)


@pytest.mark.parametrize("kind", ["camera", "inside", "nee", "axis"])
@pytest.mark.parametrize("n", sorted(BOX_SCENES))
def test_box_test_is_conservative(n, kind):
    """Every chunk, and every 32-row group, that holds an ok pair of a ray
    by ``_interval`` (for a NEE segment: one that starts before tmax) is
    admitted by the box tests (``admitted_reference``, the kernels'
    operations), so the kernels' cull skips only boxes that add exactly
    0; and on the small Gaussians the tests cull."""
    medium = parse_gmm(random_gaussian_scene(n, **BOX_SCENES[n])).medium
    table, boxes = tpb.pack_rows(medium), tpb.chunk_boxes(medium)
    o, d, tmax = box_rays(medium, kind)
    ok = _crossed(table, o, d, tmax)
    n_c = table.shape[0] // tpb.G
    hit_groups = ok.reshape(n_c, 8, tpb.GROUP, -1).any(2).permute(2, 0, 1)
    chunks, groups = tpb.admitted_reference(boxes, o, d, tmax)
    assert hit_groups.any()
    assert not (hit_groups.any(2) & ~chunks).any()
    assert not (hit_groups & ~groups).any()
    if n == 2100:
        assert chunks.float().mean() < 0.8
        assert groups.float().sum() < 0.5 * 8 * chunks.float().sum()


# The pre-test's scenes: the headline's (K1 and K2 run the pre-test in
# both sweeps), one at the megakernel's ceiling of 2,048 Gaussians, and
# the box tests' two
PRE_SCENES = {250: dict(seed=0), 2048: dict(seed=0), **BOX_SCENES}


@pytest.mark.parametrize("n", sorted(PRE_SCENES))
def test_pre_test_passes_every_ok_pair(n):
    """The kernels' division-free pre-test (``may_cross_reference``)
    passes every pair that ``_interval`` finds ok, for camera rays (the
    headline's view), far rays (those origins 20x farther out), rays from
    inside the medium and NEE segments' rays (from inside the medium
    toward the lights or in random directions; the pre-test ignores tmax,
    so it is held on the whole line), so the rows it skips add exactly 0;
    on the small Gaussians it rejects most of them."""
    medium = parse_gmm(random_gaussian_scene(n, **PRE_SCENES[n])).medium
    table = tpb.pack_rows(medium)
    o, d = [], []
    for kind in ("camera", "inside", "nee"):
        oo, dd, _ = box_rays(medium, kind, n=512)
        o += [oo, oo * 20.0] if kind == "camera" else [oo]
        d += [dd, dd] if kind == "camera" else [dd]
    o, d = torch.cat(o), torch.cat(d)
    ok = _crossed(table, o, d)
    passed = torch.cat([tpb.may_cross_reference(table, o[s:s + 256],
                                                d[s:s + 256])
                        for s in range(0, o.shape[0], 256)], dim=1)
    assert ok.any() and not (ok & ~passed).any()
    if n != 2300:        # the Gaussians' rows, not the padding's
        assert passed[:n].float().mean() < 0.05


@pytest.mark.parametrize("kind", ["camera", "inside", "nee", "axis"])
@pytest.mark.parametrize("n", [250, 2048])
def test_group_boxes_are_conservative(n, kind):
    """``megatrace.group_boxes`` (the 32-row groups of K1's table in Morton
    order, over which ``mega_reference(counts=)`` counts K1's work): they
    hold each valid row once, and every group that holds a pair a ray
    crosses by ``_interval`` (for a NEE segment: one that starts before
    tmax) meets the ray, so the count charges every pair the kernel must
    find; and a ray meets few of them."""
    medium = parse_gmm(random_gaussian_scene(n, **PRE_SCENES[n])).medium
    table = tpt.pack_table(medium)
    boxes, rows = tmt.group_boxes(table)
    assert rows.tolist() == [tpb.GROUP] * (n // tpb.GROUP) + (
        [n % tpb.GROUP] if n % tpb.GROUP else [])
    o, d, tmax = box_rays(medium, kind, n=512)
    ok = _crossed(table, o, d, tmax)[:n][torch.from_numpy(
        morton_order(table[:n, 13:16].numpy()))]
    hit = torch.nn.functional.pad(ok, (0, 0, 0, -n % tpb.GROUP)).view(
        -1, tpb.GROUP, ok.shape[1]).any(1).T
    admitted = tpb.chunk_box_hits_reference(boxes, o, d, tmax)
    assert hit.any() and not (hit & ~admitted).any()
    assert admitted.float().mean() < 0.5


def test_big_dense_bars_admit_float32_rounding():
    """BIG_DENSE_BARS admit the plain version against itself in float64
    and with the table's rows permuted (so summed in another order) on
    large overlapping Gaussians (2,300 of diameter 2-4), where K4's inset
    Illinois step leaves a few roots short of convergence; Li on the same
    NEE rays."""
    sc = parse_gmm(random_gaussian_scene(2300, **BOX_SCENES[2300]))
    table = tpb.pack_rows(sc.medium)
    o, d, xi = big_rays(sc.medium, 384, seed=5, device="cpu")
    args = (o, d, xi, sc.lights())
    s1 = tpb.big_stage1_reference(table, *args)
    perm = torch.from_numpy(np.random.default_rng(0).permutation(
        table.shape[0]))
    for other in (table.double(), table[perm].contiguous()):
        s2 = tpb.big_stage1_reference(other, *(a.to(other.dtype)
                                                for a in args)).float()
        li = [tpb.big_nee_reference(t, s1.to(t.dtype), sc.env_color
                                    .to(t.dtype)).float()
              for t in (table, other)]
        res = big_agreement((s1[0], s1[1] > 0.5, s1[2], li[0], s1[3]),
                            (s2[0], s2[1] > 0.5, s2[2], li[1], s2[3]),
                            BIG_DENSE_BARS)
        assert res["ok"] and res["agree"] == 1.0, res


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


# case: (RenderConfig's keys, how the chunk's loop ends)
BIG_LOOP_ENDS = {
    # a count of 0 read with spare iterations enqueued past it (at most
    # spp * max_bounces iterations have lanes, so a lead up to
    # max_bounces reads the 0 before cap)
    "spare": dict(spp=2, max_bounces=8),
    # max_bounces 1: a lane's every sample is one iteration, so the loop
    # has lanes for spp iterations and reaches cap = spp + 1 before it
    # reads the 0
    "cap": dict(spp=3, max_bounces=1),
}


@pytest.mark.parametrize("lead", [2, 8])
@pytest.mark.parametrize("case", sorted(BIG_LOOP_ENDS))
def test_big_loop_matches_the_host_read_loop(monkeypatch, case, lead):
    """The big-N loop, its live lanes and their count kept on the device,
    against the loop that reads them on the host each iteration, both
    over K4 and K5's plain versions at 2,100 Gaussians and 16 x 8 pixels
    in one chunk: the same image bit for bit, the same iterations, bounce
    evaluations, lanes_traced and lane_slots; the iterations it enqueued
    past the end (spare) and its waits counted as the CPU's reader, which
    reads a count only by waiting, makes them."""
    monkeypatch.setattr(tms, "LIVE_READ_LEAD", lead)
    sc = parse_gmm(_text(2100))
    cam = PinholeCamera.create([0, 1, 6], [0, 1, 0], 0.25 * math.pi)
    cfg = RenderConfig(width=16, height=8, **BIG_LOOP_ENDS[case])
    ids = tms.tile_ids(16, 8, "cpu")
    (img, st, rec), (want, st_w, rec_w) = big_loops(sc, cam, cfg, ids)
    assert img.std() > 0 and torch.equal(img, want)
    assert st["iterations"] == st_w["iterations"] > 0
    assert int(st["bounce_evals"]) == st_w["bounce_evals"]
    for k in ("lanes_traced", "lane_slots"):
        assert rec[k] == rec_w[k], k
    assert rec["lanes_traced"] == st_w["bounce_evals"]
    assert rec["lane_slots"] == 128 * st["iterations"]
    cap = cfg.spp * cfg.max_bounces + cfg.max_bounces
    enqueued = st["iterations"] + st["spare_iterations"]
    assert rec["wavefront_spare_iterations"] == st["spare_iterations"]
    # the CPU's reader reads iteration t's count (counts[t + 1]) at its
    # (t + 1)-th wait, once lead iterations are unread
    if case == "cap":
        assert st["iterations"] == cfg.spp and enqueued == cap
        assert rec["wavefront_host_waits"] == max(0, cap - lead)
    else:
        assert st["spare_iterations"] == lead - 1 and enqueued < cap
        assert rec["wavefront_host_waits"] == st["iterations"]


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
