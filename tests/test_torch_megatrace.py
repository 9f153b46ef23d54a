"""The sample/bounce loop (K1): the port's plain version against gvr_tpu's
wavefront_pixels through the Pallas megakernel in interpret mode and
through the XLA path, and the pooled CUDA kernel against the plain version
on the card.  Bar: atol 1e-4, the JAX suite's own mega-vs-XLA bar
(test_pallas_kernels.py:test_megakernel_matches_step_wavefront)."""

import math
import pathlib
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_common import port_camera, port_scene
from gvr_tpu.cameras import OrthographicCamera as JOrtho
from gvr_tpu.cameras import PinholeCamera as JPinhole
from gvr_tpu.config import RenderConfig as JConfig
from gvr_tpu.integrators.multiscatter import wavefront_pixels
from gvr_tpu.scene.generators import random_gaussian_scene
from gvr_tpu.scene.scene import parse_gmm as jax_parse_gmm
from gvr_tpu_torch.config import RenderConfig
from gvr_tpu_torch.kernels import megatrace as tmt
from gvr_tpu_torch.kernels.pathtrace import pack_table


def _mega_config(**scene_kw):
    """The test_megakernel_* configuration: 24 Gaussians (seed 7), by
    default under the generator's 3 point lights, 16^2, spp 9 (n_strat 3 exercises the
    stratum math), max_bounces 6."""
    sc = jax_parse_gmm(random_gaussian_scene(24, seed=7,
                                             diameter=(0.2, 0.6),
                                             density=(0.5, 2.0), **scene_kw))
    cam = JPinhole.create([0, 1, 6], [0, 1, 0], 0.25 * math.pi)
    return sc, cam, dict(width=16, height=16, spp=9, max_bounces=6)


def _port_mega(sc, cam, kw, device="cpu", ids=None):
    ts, tc = port_scene(sc, device), port_camera(cam, device)
    if ids is None:
        ids = torch.arange(kw["width"] * kw["height"], dtype=torch.int32,
                           device=device)
    cfg = RenderConfig(**kw)
    args = (tmt.camera_vector(tc), pack_table(ts.medium), ids, cfg,
            ts.lights(), ts.env_color, isinstance(cam, JPinhole))
    return args, cfg


@pytest.mark.parametrize("n_lights", [3, 0])
@pytest.mark.parametrize("pallas", ["interpret", "off"])
def test_mega_reference_matches_jax(pallas, n_lights):
    """With the generator's 3 point lights and without (NEE then always
    samples the environment, weight 1/4pi)."""
    sc, cam, kw = _mega_config(**({} if n_lights else {"lights": ()}))
    cfg = JConfig(pallas=pallas, wavefront="mega", **kw)
    want = np.asarray(wavefront_pixels(sc, cam, cfg,
                                       jnp.arange(256, dtype=jnp.int32)))
    args, tcfg = _port_mega(sc, cam, kw)
    assert args[4].shape == (n_lights, 6)
    before = (tmt.mega_reference.launches, tmt.mega_call.launches)
    sums, evals = tmt.mega_call(*args)
    assert (tmt.mega_reference.launches,
            tmt.mega_call.launches) == (before[0] + 1, before[1])
    got = (sums / tcfg.spp).numpy()
    assert np.isfinite(got).all() and got.shape == (256, 3)
    assert got.std() > 0
    np.testing.assert_allclose(got, want, atol=1e-4)
    # every pixel traced spp paths of 1..max_bounces bounce evaluations
    assert (evals >= 9).all() and (evals <= 9 * 6).all()


def test_mega_reference_deep_bounces_ortho():
    """Early RR (min_scatter 1) and the tail cap (from bounce 3) inside
    max_bounces 10, through the orthographic camera (y-flip)."""
    sc = jax_parse_gmm(random_gaussian_scene(16, seed=9,
                                             diameter=(0.3, 0.8),
                                             density=(1.0, 3.0)))
    cam = JOrtho.create([0, 1, 6], [0, 1, 0])
    kw = dict(width=8, height=8, spp=4, max_bounces=10, min_scatter=1,
              rr_tail_after=3, rr_cap_tail=0.4)
    want = np.asarray(wavefront_pixels(
        sc, cam, JConfig(pallas="off", **kw), jnp.arange(64, dtype=jnp.int32)))
    args, tcfg = _port_mega(sc, cam, kw)
    got = (tmt.mega_call(*args)[0] / tcfg.spp).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4)


def test_camera_vector_layout():
    sc, cam, _ = _mega_config()
    v = tmt.camera_vector(port_camera(cam)).numpy()
    assert v.shape == (16,) and v.dtype == np.float32
    np.testing.assert_array_equal(v[0:3], np.asarray(cam.position))
    np.testing.assert_array_equal(v[9:12], np.asarray(cam.view_dir))
    np.testing.assert_allclose(v[12], 1.0 / math.tan(0.125 * math.pi),
                               rtol=1e-6)
    assert tmt.camera_vector(port_camera(JOrtho.create([0, 1, 6],
                                                       [0, 1, 0])))[12] == 0


def test_mega_agreement_counts_one_diverged_path():
    """mega_agreement, the measure the card tests hold K1 to: one path of
    one pixel that took another branch shows as that path's radiance /
    spp."""
    from gvr_tpu_torch.testing import mega_agreement
    sc, cam, kw = _mega_config()
    args, tcfg = _port_mega(sc, cam, kw)
    sums, evals = tmt.mega_call(*args)
    moved = sums.clone()
    moved[17, 1] += 2.5
    res = mega_agreement((moved, evals + (torch.arange(256) == 3)),
                         (sums, evals), tcfg.spp)
    assert res["finite"] and res["off_frac"] == 1 / 256
    assert res["max_path_diff"] == pytest.approx(2.5, rel=1e-6)
    assert res["mean_diff"] == pytest.approx(2.5 / tcfg.spp / 768, rel=1e-5)
    assert res["evals_rel"] == 1 / int(evals.sum())


@pytest.mark.parametrize("spp", [1, 4, 9, 64, 256])
def test_pool_pixels(spp):
    """K1's pool of a block (``pool_pixels``): at most MEGA_MAX_PIX
    pixels, enough paths for every thread where the cap allows, about
    POOL_PATHS paths otherwise, and, for a chunk large enough, at least
    FILL_WAVES waves of blocks on the card."""
    threads = -(-tmt.MEGA_BLOCK // spp)            # pixels for a full block
    for resident in (660, 1056):
        for b in (1, 3, 203, 4096, 65536):
            pix = tmt.pool_pixels(spp, b, resident)
            assert 1 <= pix <= tmt.MEGA_MAX_PIX
            assert pix >= min(threads, tmt.MEGA_MAX_PIX)
            assert pix == min(threads, tmt.MEGA_MAX_PIX) or (
                pix * spp <= tmt.POOL_PATHS
                and -(-b // pix) >= tmt.FILL_WAVES * resident)
    # the headline's chunk on an H100 holding 5 blocks an SM
    want = {1: 128, 4: 32, 9: 24, 64: 8, 256: 2}[spp]
    assert tmt.pool_pixels(spp, 65536, 5 * 132) == want


def _kernel_constant(name: str) -> int:
    """A ``constexpr int`` of K1's source, ``csrc/kernels.cu``."""
    src = (pathlib.Path(tmt.__file__).parents[1] / "csrc" /
           "kernels.cu").read_text()
    return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))


# chunk widths: a block's pool and less, the ragged card-test chunk, the
# headline's chunk 9
PARTITION_B = (1, 3, 203, 4096, 65536)


@pytest.mark.parametrize("spp", [1, 3, 9, 64, 256, 512, 513, 1024, 4096])
def test_launch_partition(spp):
    """K1's partition of a chunk, from the launcher's pools
    (``pool_pixels`` on two cards) and from forced pools of 1, 8 and 128
    pixels, walked as the kernel walks it: ``gvr_mega`` launches ceil(b /
    pix) blocks, block k owns the ids [k pix, min((k + 1) pix, b)) and
    runs its pool in rounds of the kernel's MEGA_ROUND slots (slot g:
    pixel g // spp, sample g % spp).  Every (pixel, sample) falls in
    exactly one block and one round, each block holds whole pixels, no
    round exceeds the subtotals, the pool fits the per-pixel counters, and
    the launcher's own pools run in one round up to spp MEGA_ROUND.  The
    launcher's constants are the kernel's.  (The card test
    test_mega_kernel_pool_invariant holds the kernel itself.)"""
    rnd = _kernel_constant("MEGA_ROUND")
    max_pix = _kernel_constant("MEGA_MAX_PIX")
    assert tmt.MEGA_MAX_PIX == max_pix
    assert tmt.MEGA_BLOCK == _kernel_constant("MEGA_BLOCK")
    for b in PARTITION_B:
        pools = {tmt.pool_pixels(spp, b, r) for r in (660, 1056)}
        for pix in pools | {1, 8, 128}:
            assert 1 <= pix <= max_pix
            hits = np.zeros((b, spp), dtype=np.int64) \
                if b * spp <= 1 << 20 else None
            for k in range(-(-b // pix)):
                base = k * pix
                npix = min(pix, b - base)
                assert npix >= 1
                pool = npix * spp
                rounds = [(r0, min(r0 + rnd, pool))
                          for r0 in range(0, pool, rnd)]
                assert all(0 < r1 - r0 <= rnd for r0, r1 in rounds)
                if pix in pools and spp <= rnd:
                    assert len(rounds) == 1
                if hits is not None:
                    for r0, r1 in rounds:
                        g = np.arange(r0, r1)
                        np.add.at(hits, (base + g // spp, g % spp), 1)
            if hits is not None:
                assert (hits == 1).all()


def test_mega_phases_only_on_the_card():
    """The phase counters come from the instrumented kernel, so a CPU
    call that asks for them raises; ``phase_split`` turns counters into
    cycle shares and active lanes per warp-step."""
    sc, cam, kw = _mega_config()
    args, _ = _port_mega(sc, cam, kw)
    with pytest.raises(ValueError, match="phases"):
        tmt.mega_call(*args, phases=torch.zeros((4, 3), dtype=torch.int64))
    split = tmt.phase_split(torch.tensor([[600, 10, 320], [200, 4, 40],
                                          [150, 2, 64], [50, 5, 100]]))
    assert list(split) == list(tmt.MEGA_PHASES)
    assert sum(v[0] for v in split.values()) == pytest.approx(1.0)
    assert split["sweep"] == (0.6, 32.0) and split["solve"][1] == 10.0


def test_mega_reference_counts_the_work():
    """``mega_reference``'s optional counts (the work K1's paths need, which
    the benchmark's copy is held against):
    the evaluations equal the returned ones, the rays that scatter are
    fewer, every pair of a ray that scatters is a pair of an extension
    ray, each extension ray and shadow-ray segment meets at most every
    group box and is charged that group's rows, and the image is the same
    with and without counting."""
    sc, cam, kw = _mega_config()
    args, _ = _port_mega(sc, cam, kw)
    counts = {}
    sums, evals = tmt.mega_reference(*args, counts=counts)
    assert counts["evals"] == int(evals.sum())
    assert 0 < counts["scattered"] < counts["evals"]
    assert 0 < counts["solve_pairs"] <= counts["ext_pairs"]
    assert counts["nee_pairs"] > 0
    assert counts["groups"] == 1                 # 24 Gaussians, one group
    assert 0 < counts["ext_groups"] <= counts["evals"]
    assert 0 < counts["nee_groups"] <= counts["scattered"]
    assert counts["ext_rows"] == 24 * counts["ext_groups"]
    assert counts["nee_rows"] == 24 * counts["nee_groups"]
    again = tmt.mega_reference(*args)
    assert torch.equal(again[0], sums) and torch.equal(again[1], evals)
