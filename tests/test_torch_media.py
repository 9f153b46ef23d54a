"""Sphere and voxel media of the port on the CPU against the JAX package:
SphereMixture, VoxelGrid (intersect, trilinear sampling, sigma_albedo,
the bake from Gaussians), the SMM and .npz loaders, the sphere generator,
the sphere marcher, the pure marcher and the hit mask on both media, and
the port's own versions of the JAX package's closed-form and
cross-representation tests (tests/test_integrators.py,
tests/test_voxels.py).  Inputs are made with numpy from a seed and
carried across with ``gvr_tpu_torch.scene.convert``."""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_common  # noqa: F401  (sets torch threads)
from _torch_common import port_camera, port_scene
from gvr_tpu.cameras import OrthographicCamera as JOrtho
from gvr_tpu.cameras import PinholeCamera as JPinhole
from gvr_tpu.config import RenderConfig as JConfig
from gvr_tpu.integrators.raymarch import render_pure_raymarch as jax_pure
from gvr_tpu.integrators.raymarch import \
    render_raymarch_spheres as jax_spheres
from gvr_tpu.integrators.test_hit import render_hit_mask as jax_hit_mask
from gvr_tpu.scene import generators as jgen
from gvr_tpu.scene import scene as jscene
from gvr_tpu.scene.voxels import VoxelGrid as JVoxels
from gvr_tpu.scene.voxels import load_voxels as jax_load_voxels
from gvr_tpu_torch.cameras import OrthographicCamera, pixel_center_uv
from gvr_tpu_torch.config import RenderConfig
from gvr_tpu_torch.integrators import raymarch
from gvr_tpu_torch.integrators.freeflight import render_single_scatter
from gvr_tpu_torch.integrators.multiscatter import render_multiscatter
from gvr_tpu_torch.integrators.raymarch import (render_pure_raymarch,
                                                render_raymarch_spheres)
from gvr_tpu_torch.integrators.test_hit import render_hit_mask
from gvr_tpu_torch.inverse.fit import fit_gaussians
from gvr_tpu_torch.scene.gaussians import GaussianMixture
from gvr_tpu_torch.scene.generators import (random_gaussian_scene,
                                            random_sphere_scene)
from gvr_tpu_torch.scene.scene import (load_scene, load_smm, load_vdb,
                                       parse_gmm, parse_smm)
from gvr_tpu_torch.scene.spheres import SphereMixture
from gvr_tpu_torch.scene.voxels import VoxelGrid, load_voxels

SPHERES16 = random_sphere_scene(16, seed=0)
# a generator scene of fat Gaussians, so a coarse bake resolves them
FAT = dict(diameter=(0.2, 0.6), density=(0.5, 2.0))
# the marchers' comparison size: 16^2, step 0.05, 2 environment samples;
# the JAX package pads every chunk to cfg.ray_chunk rays
MARCH = dict(width=16, height=16, step_size=0.05, env_samples=2,
             ray_chunk=256)


def _rays(n: int, seed: int):
    """(o, d) float32 numpy rays from around and inside the scenes' box,
    each aimed at a random point of the box."""
    r = np.random.default_rng(seed)
    o = (r.uniform(-3.0, 3.0, (n, 3)) + [0.0, 1.0, 2.0]).astype(np.float32)
    d = r.uniform([-1.5, 0.0, -1.5], [1.5, 2.5, 1.5], (n, 3)) - o
    return o, (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(
        np.float32)


def _spheres(seed: int = 0):
    jsc = jscene.parse_smm(jgen.random_sphere_scene(16, seed))
    return jsc, port_scene(jsc)


def _voxel_scene(res: int = 6, seed: int = 0):
    """A random res^3 grid (sigma_t 0-3, albedo 0.2-0.9) over a box that
    covers part of the image, under the sphere scene's light, in the JAX
    package and in the port."""
    r = np.random.default_rng(seed)
    jsc = jscene.parse_smm(SPHERES16).with_medium(JVoxels.create(
        [-0.6, 0.4, -0.6], [0.6, 1.7, 0.6],
        r.uniform(0.0, 3.0, (res,) * 3).astype(np.float32),
        r.uniform(0.2, 0.9, (res,) * 3).astype(np.float32)))
    return jsc, port_scene(jsc)


def _cams(camera: str):
    jcam = (JPinhole.create([0, 1, 6], [0, 1, 0], 0.25 * math.pi)
            if camera == "pinhole" else JOrtho.create([0, 1, 6], [0, 1, 0]))
    return jcam, port_camera(jcam)


# ---- SphereMixture -------------------------------------------------------

def test_sphere_intersect_matches_jax():
    """t_enter / t_exit within 2 ulp of their scale (tca's fused
    multiply-adds and l.l's plain sum are XLA's; sqrt may round apart),
    the hit decision equal on 99.9 % of the (ray, sphere) pairs: a ray
    that grazes a rim, where d2 = l.l - tca^2 cancels, may decide the
    other way."""
    jsc, tsc = _spheres()
    o, d = _rays(4096, 1)
    jt0, jt1, jhit = (np.asarray(a) for a in jsc.medium.intersect(
        jnp.asarray(o), jnp.asarray(d)))
    t0, t1, hit = tsc.medium.intersect(torch.from_numpy(o),
                                       torch.from_numpy(d))
    assert (hit.numpy() == jhit).mean() >= 0.999 and jhit.mean() > 0.05
    both = hit.numpy() & jhit
    for got, want in ((t0, jt0), (t1, jt1)):
        err = np.abs(got.numpy() - want)[both]
        assert (err <= 2 * np.spacing(np.abs(want[both]) + 1.0)).all()


def test_sphere_transmittance_and_sigma_match_jax():
    """transmittance_up_to with a per-ray and a scalar tmax: atol 1e-6
    (the sum over spheres is torch's, not XLA's sequential order);
    sigma_at on a random mask: rtol 1e-6."""
    jsc, tsc = _spheres()
    o, d = _rays(4096, 2)
    tmax = np.random.default_rng(3).uniform(0.1, 5.0, 4096).astype(
        np.float32)
    for jt, tt in ((jnp.asarray(tmax), torch.from_numpy(tmax)),
                   (jnp.float32(1e8), 1e8)):
        want = np.asarray(jsc.medium.transmittance_up_to(
            jnp.asarray(o), jnp.asarray(d), jt))
        got = tsc.medium.transmittance_up_to(torch.from_numpy(o),
                                             torch.from_numpy(d), tt)
        assert want.min() < 0.5
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
    mask = np.random.default_rng(4).uniform(size=(4096, 16)) < 0.3
    for got, want in zip(tsc.medium.sigma_at(torch.from_numpy(mask)),
                         jsc.medium.sigma_at(jnp.asarray(mask))):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-6)


def test_sphere_generator_and_parser_match_jax(tmp_path):
    for n, seed in ((1, 0), (16, 0), (40, 9)):
        assert random_sphere_scene(n, seed) == jgen.random_sphere_scene(
            n, seed)
    text = SPHERES16 + "# note\ns 0 1\ng 0 1\n"
    want = jscene.parse_smm(text)
    got = parse_smm(text)
    assert isinstance(got.medium, SphereMixture) and got.medium.n == 16
    for k in ("center", "radius", "sigma_a", "sigma_s"):
        assert np.array_equal(getattr(got.medium, k).numpy(),
                              np.asarray(getattr(want.medium, k))), k
    assert np.array_equal(got.lights_i.numpy(), np.asarray(want.lights_i))
    path = tmp_path / "spheres.txt"
    path.write_text(SPHERES16)
    assert torch.equal(load_smm(path).medium.center, got.medium.center)


# ---- VoxelGrid ------------------------------------------------------------

def test_voxel_intersect_matches_jax():
    """The slab test with the 1e-12 guard, bit for bit, including rays
    along a face (a zero direction component, either sign)."""
    r = np.random.default_rng(5)
    grid = r.uniform(0, 1, (5, 6, 7)).astype(np.float32)
    jv = JVoxels.create([-1, 0, -1], [1, 2, 1.5], grid, 0.5)
    tv = VoxelGrid.create([-1, 0, -1], [1, 2, 1.5], grid, 0.5)
    o, d = _rays(2048, 6)
    d[:64, 0] = 0.0
    d[64:128, 1] = -0.0
    for got, want in zip(tv.intersect(torch.from_numpy(o),
                                      torch.from_numpy(d)),
                         jv.intersect(jnp.asarray(o), jnp.asarray(d))):
        assert got.shape == (2048, 1)
        assert np.array_equal(got.numpy(), np.asarray(want))
    _, _, hit = tv.intersect(torch.tensor([[0.0, 1.0, 6.0]]),
                             torch.tensor([[0.0, 0.0, -1.0]]))
    assert bool(hit[0, 0])


def test_trilinear_matches_jax():
    """Bit for bit against the JAX package's _trilinear at random points
    inside and outside the box; exact at the cell centres; the mean at the
    midpoint of two centres (tests/test_voxels.py)."""
    r = np.random.default_rng(7)
    grid = np.arange(4 * 5 * 6, dtype=np.float32).reshape(4, 5, 6)
    tv = VoxelGrid.create([0, 0, 0], [1, 1, 1], grid, 0.5)
    jv = JVoxels.create([0, 0, 0], [1, 1, 1], grid, 0.5)
    x = r.uniform(-0.2, 1.2, (4096, 3)).astype(np.float32)
    got = tv._trilinear(tv.sigma_t, torch.from_numpy(x)).numpy()
    assert np.array_equal(got, np.asarray(jv._trilinear(jv.sigma_t,
                                                        jnp.asarray(x))))
    idx = np.stack(np.meshgrid(np.arange(4), np.arange(5), np.arange(6),
                               indexing="ij"), axis=-1).reshape(-1, 3)
    centres = torch.tensor((idx + 0.5) / [4, 5, 6], dtype=torch.float32)
    np.testing.assert_allclose(tv._trilinear(tv.sigma_t, centres).numpy(),
                               grid.reshape(-1), atol=1e-5)
    g = np.zeros((4, 4, 4), np.float32)
    g[1, 2, 2], g[2, 2, 2] = 3.0, 5.0
    vg = VoxelGrid.create([0, 0, 0], [1, 1, 1], g, 0.5)
    mid = vg._trilinear(vg.sigma_t, torch.tensor([[0.5, 0.625, 0.625]]))
    assert abs(float(mid[0]) - 4.0) < 1e-5


def test_voxel_sigma_albedo_matches_jax():
    jv, tv = _voxel_scene()
    r = np.random.default_rng(8)
    x = (r.uniform(-0.8, 0.8, (4096, 3)) + [0, 1, 0]).astype(np.float32)
    mask = r.uniform(size=(4096, 1)) < 0.7
    for got, want in zip(tv.medium.sigma_albedo(torch.from_numpy(x),
                                                torch.from_numpy(mask)),
                         jv.medium.sigma_albedo(jnp.asarray(x),
                                                jnp.asarray(mask))):
        assert np.array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("res", [16, 24])
def test_from_gaussians_matches_jax(res):
    """The bake of a generator scene: the box bit for bit, sigma_t and the
    albedo within 1e-6 of their largest value (the Gaussians' exp and the
    sums over N round apart)."""
    jsc = jscene.parse_gmm(jgen.random_gaussian_scene(40, 0, **FAT))
    want = JVoxels.from_gaussians(jsc.medium, res=res)
    got = VoxelGrid.from_gaussians(port_scene(jsc).medium, res=res)
    assert got.res == (res, res, res)
    for k in ("lo", "hi"):
        assert np.array_equal(getattr(got, k).numpy(),
                              np.asarray(getattr(want, k))), k
    for k in ("sigma_t", "albedo"):
        w = np.asarray(getattr(want, k))
        np.testing.assert_allclose(getattr(got, k).numpy(), w, rtol=0,
                                   atol=1e-6 * np.abs(w).max())
    # the mean-albedo filler where the field vanishes
    assert (got.sigma_t.numpy() <= 1e-25).any()


def test_load_voxels_and_load_scene_dispatch(tmp_path):
    """The .npz round trip against the JAX package's load_voxels, and
    load_scene's dispatch: .npz -> VoxelGrid, 'g' lines -> GMM, 's' lines
    -> SMM; OpenVDB raises the JAX package's NotImplementedError."""
    sig = np.random.default_rng(0).uniform(0, 1, (6, 6, 6)).astype(
        np.float32)
    path = tmp_path / "vox.npz"
    np.savez(path, sigma_t=sig, albedo=np.float32(0.7),
             lo=np.asarray([-1, -1, -1], np.float32),
             hi=np.asarray([1, 1, 1], np.float32),
             lights=np.asarray([[0, 4, 0, 35, 35, 35]], np.float32))
    want = jax_load_voxels(str(path))
    got = load_voxels(str(path))
    assert got.num_lights == 1 and got.medium.res == (6, 6, 6)
    for k in ("lo", "hi", "sigma_t", "albedo"):
        assert np.array_equal(getattr(got.medium, k).numpy(),
                              np.asarray(getattr(want.medium, k))), k
    for k in ("lights_p", "lights_i", "env_color"):
        assert np.array_equal(getattr(got, k).numpy(),
                              np.asarray(getattr(want, k))), k
    np.savez(tmp_path / "bare.npz", sigma_t=sig)
    bare = load_scene(tmp_path / "bare.npz")
    assert bare.num_lights == 0 and bare.medium.hi.tolist() == [1, 1, 1]
    assert isinstance(load_scene(path).medium, VoxelGrid)
    (tmp_path / "s.txt").write_text(SPHERES16)
    (tmp_path / "g.txt").write_text(random_gaussian_scene(3, 0))
    assert isinstance(load_scene(tmp_path / "s.txt").medium, SphereMixture)
    assert isinstance(load_scene(tmp_path / "g.txt").medium,
                      GaussianMixture)
    assert load_scene(tmp_path / "s.txt").is_gaussian is False
    message = "OpenVDB parsing not supported; convert to .npz"
    with pytest.raises(NotImplementedError, match=message):
        jscene.load_vdb(tmp_path / "x.vdb")
    for fn in (load_vdb, load_scene):
        with pytest.raises(NotImplementedError, match=message):
            fn(tmp_path / "x.vdb")


# ---- the marchers and the hit mask ------------------------------------

@pytest.mark.parametrize("camera", ["pinhole", "orthographic"])
def test_raymarch_spheres_matches_jax(camera):
    """The sphere marcher at 16^2, step 0.05, 2 environment samples:
    rtol 1e-4 / atol 1e-5 on every pixel."""
    jcam, tcam = _cams(camera)
    jsc, tsc = _spheres()
    want = np.asarray(jax_spheres(jsc, jcam, JConfig(**MARCH)))
    stats = {}
    got = render_raymarch_spheres(tsc, tcam, RenderConfig(**MARCH),
                                  device="cpu", stats=stats)
    assert got.std() > 0 and 0 < stats["steps"] < stats["n_steps"]
    assert stats["k3_launches"] == stats["steps"]
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("medium", ["spheres", "voxels"])
def test_pure_raymarch_matches_jax(medium):
    """The pure marcher at 16^2, step 0.05, 2 environment samples on the
    sphere scene and on a random 6^3 grid: rtol 1e-4 / atol 1e-5."""
    jcam, tcam = _cams("pinhole")
    jsc, tsc = _spheres() if medium == "spheres" else _voxel_scene()
    want = np.asarray(jax_pure(jsc, jcam, JConfig(**MARCH)))
    stats = {}
    got = render_pure_raymarch(tsc, tcam, RenderConfig(**MARCH),
                               device="cpu", stats=stats)
    assert got.std() > 0 and stats["shadow_steps"] > stats["n_steps"] // 2
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("medium", ["spheres", "voxels"])
def test_march_range_shortcut_changes_no_bit(monkeypatch, medium):
    """The port marches only from the step before the first entry to the
    last exit; marching every step, as the JAX package does, gives the
    same bits on both media."""
    tcam = _cams("orthographic")[1]
    tsc = _spheres()[1] if medium == "spheres" else _voxel_scene()[1]
    cfg = RenderConfig(width=8, height=8, step_size=0.1, env_samples=1)
    render = (render_raymarch_spheres if medium == "spheres"
              else render_pure_raymarch)
    stats = {}
    short = render(tsc, tcam, cfg, device="cpu", stats=stats)
    monkeypatch.setattr(raymarch, "_march_range",
                        lambda t0, t1, hit, tmax, step, n: (0, n))
    full = render(tsc, tcam, cfg, device="cpu")
    assert stats["steps"] < stats["n_steps"]
    assert np.array_equal(short, full)


@pytest.mark.parametrize("medium", ["spheres", "voxels"])
def test_hit_mask_matches_jax(medium):
    """Bit for bit, on the sphere scene and on a grid whose box covers
    part of the image."""
    jcam, tcam = _cams("pinhole")
    jsc, tsc = _spheres() if medium == "spheres" else _voxel_scene()
    want = np.asarray(jax_hit_mask(jsc, jcam, JConfig(**MARCH)))
    got = render_hit_mask(tsc, tcam, RenderConfig(**MARCH), device="cpu")
    assert np.array_equal(got, want)
    assert 0 < (got[..., 1] < 0.5).mean() < 1


def test_raymarch_spheres_pure_absorption():
    """tests/test_integrators.py:118: one absorbing sphere, no light, one
    environment sample: L = exp(-sigma_a chord) env at atol 2e-2."""
    sc = parse_smm("s 0 1 0  1.0  0.8 0.0\n")
    cam = OrthographicCamera.create([0, 1, 6], [0, 1, 0])
    cfg = RenderConfig(width=24, height=24, env_samples=1, step_size=0.01)
    img = render_raymarch_spheres(sc, cam, cfg, device="cpu")
    o, d = cam.sample_ray(pixel_center_uv(24, 24).reshape(-1, 2))
    t0, t1, hit = sc.medium.intersect(o, d)
    chord = torch.where(hit[:, 0], (t1 - t0)[:, 0], 0.0).numpy()
    want = (np.exp(-0.8 * chord)[:, None]
            * sc.env_color.numpy()).reshape(24, 24, 3)
    np.testing.assert_allclose(img, want, atol=2e-2)


def test_baked_gmm_renders_like_gmm():
    """tests/test_voxels.py's cross-representation check on a generator
    scene: the Gaussians and their 48^3 bake through the same pure marcher
    at 12^2 (step 0.06, 2 environment samples): mean |diff| below 0.01
    and max below 0.05."""
    sc = parse_gmm(random_gaussian_scene(6, 1, diameter=(0.3, 0.8),
                                         density=(0.5, 1.5)))
    scv = sc.with_medium(VoxelGrid.from_gaussians(sc.medium, res=48))
    cam = _cams("pinhole")[1]
    cfg = RenderConfig(width=12, height=12, step_size=0.06, env_samples=2)
    img_g = render_pure_raymarch(sc, cam, cfg, device="cpu")
    img_v = render_pure_raymarch(scv, cam, cfg, device="cpu")
    d = np.abs(img_g - img_v)
    assert np.isfinite(img_v).all() and img_g.std() > 0
    assert d.mean() < 0.01 and d.max() < 0.05, (d.mean(), d.max())


@pytest.mark.parametrize("medium", ["spheres", "voxels"])
def test_gaussian_integrators_refuse_other_media(medium):
    """render_multiscatter, render_single_scatter and the fit take
    Gaussian media only, as in the JAX package; the port raises a
    TypeError that names the integrators that render the medium."""
    sc = parse_smm(SPHERES16) if medium == "spheres" else _voxel_scene()[1]
    cam = _cams("pinhole")[1]
    cfg = RenderConfig(width=8, height=8, spp=1)
    names = "raymarch, pureraymarch" if medium == "spheres" \
        else "pureraymarch"
    for call in (lambda: render_multiscatter(sc, cam, cfg, device="cpu"),
                 lambda: render_single_scatter(sc, cam, cfg, device="cpu"),
                 lambda: fit_gaussians(sc, cam, np.zeros((8, 8, 3)))):
        with pytest.raises(TypeError, match=f"Gaussian media only.*{names}"):
            call()
    if medium == "voxels":
        with pytest.raises(TypeError, match="SphereMixture"):
            render_raymarch_spheres(sc, cam, cfg, device="cpu")
