"""Host foundation of the port against gvr_tpu: the packed table, the
mixture precompute, the GMM parser, the cameras and the PPM codec."""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_common import port_camera, port_scene
from gvr_tpu.cameras import OrthographicCamera as JOrtho
from gvr_tpu.cameras import PinholeCamera as JPinhole
from gvr_tpu.io import ppm as jppm
from gvr_tpu.kernels.pathtrace import pack_table as jax_pack_table
from gvr_tpu.scene.generators import random_gaussian_scene as jax_generator
from gvr_tpu.scene.scene import load_scene as jax_load_scene
from gvr_tpu.scene.scene import parse_gmm as jax_parse_gmm
from gvr_tpu_torch.cameras import OrthographicCamera, PinholeCamera
from gvr_tpu_torch.io import ppm
from gvr_tpu_torch.kernels.pathtrace import pack_table
from gvr_tpu_torch.scene.generators import random_gaussian_scene
from gvr_tpu_torch.scene.scene import DEFAULT_ENV_COLOR, load_scene, parse_gmm


def test_generator_is_a_copy():
    for n, seed in ((3, 0), (250, 0), (40, 9)):
        assert random_gaussian_scene(n, seed) == jax_generator(n, seed)


@pytest.mark.parametrize("n", [5, 250])
def test_pack_table_equals_jax(n):
    sc = jax_parse_gmm(jax_generator(n, seed=1, diameter=(0.05, 0.4)))
    want = np.asarray(jax_pack_table(sc.medium))[:, :16]
    got = pack_table(port_scene(sc).medium).numpy()
    assert got.shape == want.shape == (max(8, -(-n // 8) * 8), 16)
    # columns 0-5 and 10-15 are copies or one product: exactly equal;
    # q and c0 are 3-term dot products whose XLA summation may fuse
    exact = list(range(6)) + list(range(10, 16))
    assert np.array_equal(got[:, exact], want[:, exact])
    np.testing.assert_allclose(got[:, 6:10], want[:, 6:10], rtol=1e-6,
                               atol=1e-6 * np.abs(want[:, 6:10]).max())


def test_from_covariances_matches_jax():
    # the main path's scene; two float32 eigh implementations differ by
    # rounding, so each Gaussian's values are compared relative to its own
    # largest entry
    text = jax_generator(250, seed=0)
    want = jax_parse_gmm(text).medium
    got = parse_gmm(text).medium
    for k in ("mean", "cov", "density", "albedo", "emission"):
        assert np.array_equal(getattr(got, k).numpy(),
                              np.asarray(getattr(want, k))), k
    for k in ("inv_cov", "norm", "eigvals"):
        w = np.asarray(getattr(want, k)).reshape(250, -1)
        g = getattr(got, k).numpy().reshape(250, -1)
        rel = np.abs(g - w) / np.abs(w).max(axis=1, keepdims=True)
        assert rel.max() < 1e-5, (k, rel.max())
    # eigenvectors: a proper rotation spanning the same axes
    ev = got.eigvecs.numpy().astype(np.float64)
    assert np.allclose(np.linalg.det(ev), 1.0, atol=1e-5)
    recon = np.einsum("nij,nj,nkj->nik", ev, got.eigvals.numpy(), ev)
    np.testing.assert_allclose(recon, np.asarray(want.cov),
                               atol=1e-6 * np.abs(want.cov).max())


def test_from_covariances_in_batches_matches_jax():
    """Above EIGH_BATCH Gaussians the eighs run in batches (cuSOLVER
    refuses one of 40,000): the 9,000 Gaussians' eigenvalues and inverse
    covariances within 1e-5 of each one's largest entry, as above."""
    from gvr_tpu_torch.scene.gaussians import EIGH_BATCH
    text = jax_generator(9000, seed=1)
    want = jax_parse_gmm(text).medium
    got = parse_gmm(text).medium
    assert got.n == 9000 > EIGH_BATCH
    for k in ("inv_cov", "eigvals"):
        w = np.asarray(getattr(want, k)).reshape(9000, -1)
        g = getattr(got, k).numpy().reshape(9000, -1)
        rel = np.abs(g - w) / np.abs(w).max(axis=1, keepdims=True)
        assert rel.max() < 1e-5, (k, rel.max())


def test_parse_skip_rules_and_load(tmp_path):
    text = ("# comment line\n"
            "l 0 5 0   10 20 30\n"
            "x 1 2 3\n"
            "g 0 1 0  0.1 0 0 0.1 0 0.1  1.5 0.8 # trailing note\n"
            "g 0 1\n"
            "g 1 1 0  0.2 0.01 0 0.1 0 0.3  2.0 0.5  0.1 0.2 0.3\n")
    sc = parse_gmm(text)
    assert sc.medium.n == 2 and sc.num_lights == 1
    assert sc.lights_i.tolist() == [[10.0, 20.0, 30.0]]
    assert sc.medium.emission[1].tolist() == pytest.approx([0.1, 0.2, 0.3])
    assert sc.env_color.tolist() == pytest.approx(list(DEFAULT_ENV_COLOR))
    path = tmp_path / "s.txt"
    path.write_text(text)
    loaded = load_scene(path)
    assert torch.equal(loaded.medium.inv_cov, sc.medium.inv_cov)
    # sphere text and voxel .npz scenes load as in the JAX package; an
    # OpenVDB file still raises its NotImplementedError
    path_s = tmp_path / "spheres.txt"
    path_s.write_text("s 0 1 0  0.5 0.1 0.4\n")
    sph, jsph = load_scene(path_s), jax_load_scene(path_s)
    for k in ("center", "radius", "sigma_a", "sigma_s"):
        assert np.array_equal(getattr(sph.medium, k).numpy(),
                              np.asarray(getattr(jsph.medium, k))), k
    path_v = tmp_path / "grid.npz"
    np.savez(path_v, sigma_t=np.full((4, 4, 4), 0.5, np.float32))
    vox, jvox = load_scene(path_v), jax_load_scene(path_v)
    for k in ("lo", "hi", "sigma_t", "albedo"):
        assert np.array_equal(getattr(vox.medium, k).numpy(),
                              np.asarray(getattr(jvox.medium, k))), k
    with pytest.raises(NotImplementedError):
        load_scene(tmp_path / "grid.vdb")


@pytest.mark.parametrize("kind", ["pinhole", "orthographic", "vertical"])
def test_cameras_match_jax(kind):
    if kind == "pinhole":
        jc = JPinhole.create([0.3, 1.0, 6.0], [0.0, 1.2, 0.0], 0.3 * math.pi)
        tc = PinholeCamera.create([0.3, 1.0, 6.0], [0.0, 1.2, 0.0],
                                  0.3 * math.pi)
    elif kind == "orthographic":
        jc = JOrtho.create([2.0, 3.0, 5.0], [0.0, 1.0, 0.0])
        tc = OrthographicCamera.create([2.0, 3.0, 5.0], [0.0, 1.0, 0.0])
    else:   # straight down: the z-axis fallback of make_frame
        jc = JPinhole.create([0.0, 5.0, 0.0], [0.0, 0.0, 0.0], 0.25 * math.pi)
        tc = PinholeCamera.create([0.0, 5.0, 0.0], [0.0, 0.0, 0.0],
                                  0.25 * math.pi)
    for k in ("position", "view_dir", "right", "up"):
        np.testing.assert_allclose(getattr(tc, k).numpy(),
                                   np.asarray(getattr(jc, k)), atol=1e-6)
    uv = np.random.default_rng(0).uniform(size=(64, 2)).astype(np.float32)
    jo, jd = jc.sample_ray(jnp.asarray(uv))
    to, td = tc.sample_ray(torch.from_numpy(uv))
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), atol=1e-6)
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), atol=1e-6)
    # the JAX camera's own leaves carry over unchanged
    assert torch.equal(port_camera(jc).position,
                       torch.tensor(np.asarray(jc.position)))


def test_ppm_bytes_identical(tmp_path):
    img = np.random.default_rng(3).uniform(-0.2, 1.3, (7, 11, 3))
    img = img.astype(np.float32)
    jppm.write_ppm(str(tmp_path / "jax.ppm"), img)
    ppm.write_ppm(str(tmp_path / "port.ppm"), img)
    data = (tmp_path / "port.ppm").read_bytes()
    assert data == (tmp_path / "jax.ppm").read_bytes()
    assert np.array_equal(ppm.quantize(img), jppm.quantize(img))
    back = ppm.read_ppm(str(tmp_path / "port.ppm"))
    assert np.array_equal(back, jppm.decode_ppm(data))
    assert back.shape == (7, 11, 3)
