"""The slice end to end: the port's render_multiscatter and render CLI on
the CPU against gvr_tpu's render_multiscatter (CPU, XLA path)."""

import math

import numpy as np
import pytest

import _torch_common  # noqa: F401  (sets torch threads)
from gvr_tpu.cameras import OrthographicCamera as JOrtho
from gvr_tpu.cameras import PinholeCamera as JPinhole
from gvr_tpu.config import RenderConfig as JConfig
from gvr_tpu.integrators.multiscatter import \
    render_multiscatter as jax_render
from gvr_tpu.integrators.multiscatter import tile_order as jax_tile_order
from gvr_tpu.integrators.raymarch import render_raymarch_spheres
from gvr_tpu.scene.generators import random_gaussian_scene
from gvr_tpu.scene.scene import parse_gmm as jax_parse_gmm
from gvr_tpu.scene.scene import parse_smm as jax_parse_smm
from gvr_tpu_torch import cli
from gvr_tpu_torch.cameras import OrthographicCamera, PinholeCamera
from gvr_tpu_torch.config import RenderConfig
from gvr_tpu_torch.integrators.multiscatter import (render_multiscatter,
                                                    tile_order)
from gvr_tpu_torch.io.ppm import quantize, read_ppm
from gvr_tpu_torch.scene.scene import parse_gmm
from gvr_tpu_torch.testing import image_agreement

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


def test_tile_order_matches_jax():
    for w, h in ((32, 32), (48, 24), (17, 9)):
        assert np.array_equal(tile_order(w, h), jax_tile_order(w, h))


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
