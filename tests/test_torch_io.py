"""The port's I/O on the CPU against the JAX package: the GIF writer (the
adaptive palette, the palette lookup, the literal-code stream and the
native full-LZW encoder, byte for byte), the turntable, the Mitsuba XML
loader and the CLI's sphere, voxel and animate paths (the port's versions
of tests/test_cli.py's voxel and animate tests)."""

import math
import shutil

import numpy as np
import pytest

import _torch_common  # noqa: F401  (sets torch threads)
from _torch_common import port_scene
from gvr_tpu.config import RenderConfig as JConfig
from gvr_tpu.io import gif as jgif
from gvr_tpu.io import ppm as jppm
from gvr_tpu.io.mitsuba import load_mitsuba as jax_load_mitsuba
from gvr_tpu.io.turntable import render_turntable as jax_turntable
from gvr_tpu.native import loader as jax_native
from gvr_tpu.scene.scene import parse_gmm as jax_parse_gmm
from gvr_tpu.scene.scene import parse_smm as jax_parse_smm
from gvr_tpu_torch import cli
from gvr_tpu_torch.cameras import OrthographicCamera, PinholeCamera
from gvr_tpu_torch.config import RenderConfig
from gvr_tpu_torch.integrators.raymarch import (render_pure_raymarch,
                                                render_raymarch_spheres)
from gvr_tpu_torch.integrators.test_hit import render_hit_mask
from gvr_tpu_torch.io import gif, ppm
from gvr_tpu_torch.io.mitsuba import load_mitsuba
from gvr_tpu_torch.io.turntable import render_turntable
from gvr_tpu_torch.scene.generators import (random_gaussian_scene,
                                            random_sphere_scene)
from gvr_tpu_torch.scene.scene import parse_smm

SPHERES16 = random_sphere_scene(16, seed=0)


def _frames(seed: int, h: int = 40, w: int = 56):
    """Three float32 frames: noise (the adaptive palette's worst case), a
    smooth gradient and a constant."""
    r = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w].astype(np.float32)
    grad = np.stack([x / w * 0.5 + 0.2, y / h * 0.4 + 0.3,
                     np.full_like(x, 0.55)], axis=-1)
    return [r.uniform(0, 1, (h, w, 3)).astype(np.float32), grad,
            np.full((h, w, 3), 0.25, np.float32)]


# ---- the GIF writer ----------------------------------------------------

def test_palette_and_indices_match_jax():
    """adaptive_palette, palette_indices and rgba_buffer byte for byte, on
    the three frames and on a 256^2 noisy gradient; the gradient maps
    within 0.02 of itself (tests/test_native.py)."""
    frames = _frames(1)
    big = (np.random.default_rng(2).uniform(0, 0.3, (256, 256, 3))
           + np.linspace(0, 0.7, 256)[None, :, None]).astype(np.float32)
    for fr in frames + [big]:
        u8 = ppm.quantize(fr)
        pal = gif.adaptive_palette(u8)
        assert np.array_equal(pal, jgif.adaptive_palette(u8))
        idx = gif.palette_indices(u8, pal)
        assert idx.dtype == np.uint8
        assert np.array_equal(idx, jgif.palette_indices(u8, pal))
        assert np.array_equal(ppm.rgba_buffer(fr), jppm.rgba_buffer(fr))
    u8 = ppm.quantize(frames[1])
    pal = gif.adaptive_palette(u8)
    err = np.abs(pal[gif.palette_indices(u8, pal)] / 255.0 - frames[1])
    assert err.max() < 0.02


@pytest.mark.parametrize("n", [1, 253, 254, 255, 2240])
def test_literal_stream_matches_jax(n):
    idx = np.random.default_rng(n).integers(0, 256, n).astype(np.uint8)
    stream = gif._lzw_literal_stream(idx)
    assert stream == jgif._lzw_literal_stream(idx)
    assert gif._sub_blocks(stream) == jgif._sub_blocks(stream)
    assert np.array_equal(gif._palette_676(), jgif._palette_676())


def test_python_writer_matches_jax(tmp_path):
    frames = _frames(3)
    gif._write_gif_python(tmp_path / "t.gif", frames, 56, 40, 4)
    jgif._write_gif_python(tmp_path / "j.gif", frames, 56, 40, 4)
    raw = (tmp_path / "t.gif").read_bytes()
    assert raw == (tmp_path / "j.gif").read_bytes()
    assert raw.startswith(b"GIF89a") and raw.endswith(b"\x3b")


def test_native_writer_matches_jax(tmp_path):
    """The port's own build of its copy of the encoder (csrc/gif_native.cpp,
    c++ into gvr_tpu_torch/_build/) against gvr_tpu.io.gif.write_gif on the
    JAX package's committed library: the same bytes.  Skipped only where
    no C++ compiler exists."""
    if shutil.which("c++") is None:
        pytest.skip("no C++ compiler (c++) to build the native GIF encoder")
    if jax_native.lib() is None or not jax_native.lib().has_indexed_gif:
        pytest.skip("the JAX package's native library does not load")
    frames = _frames(4)
    gif.write_gif(tmp_path / "t.gif", frames, delay_cs=4)
    assert gif.last_backend == "native"
    jgif.write_gif(str(tmp_path / "j.gif"), frames, delay_cs=4)
    raw = (tmp_path / "t.gif").read_bytes()
    assert raw == (tmp_path / "j.gif").read_bytes()
    # full LZW: smaller than the literal-code stream
    gif._write_gif_python(tmp_path / "p.gif", frames, 56, 40, 4)
    assert len(raw) < (tmp_path / "p.gif").stat().st_size


@pytest.mark.parametrize("backend", ["native", "python"])
def test_gif_decodes(tmp_path, backend):
    """Both backends decode (PIL) to their palette images: the screen
    size, the frame count, the noise frame within 0.06 on average and the
    gradient within 0.03 everywhere (tests/test_native.py's bars), the
    constant frame within 5/255 (the truncation to a byte, then to the
    15-bit histogram's cell, whose colour is its centre)."""
    image = pytest.importorskip("PIL.Image")
    frames = _frames(5)
    path = tmp_path / "a.gif"
    if backend == "native":
        if shutil.which("c++") is None:
            pytest.skip("no C++ compiler (c++)")
        gif.write_gif(path, frames, delay_cs=4)
        assert gif.last_backend == "native"
    else:
        gif._write_gif_python(path, frames, 56, 40, 4)
    im = image.open(path)
    assert im.size == (56, 40) and im.n_frames == 3
    decoded = []
    for i in range(3):
        im.seek(i)
        decoded.append(np.asarray(im.convert("RGB"), np.float32) / 255.0)
    assert np.abs(decoded[0] - frames[0]).mean() < 0.06
    assert np.abs(decoded[1] - frames[1]).max() < 0.03
    assert np.abs(decoded[2] - frames[2]).max() <= 5 / 255


# ---- the turntable ------------------------------------------------------

def _decoded(path):
    image = pytest.importorskip("PIL.Image")
    im = image.open(path)
    out = []
    for i in range(im.n_frames):
        im.seek(i)
        out.append(np.asarray(im.convert("RGB"), np.float32) / 255.0)
    return np.stack(out)


@pytest.mark.parametrize("integrator", ["raymarch", "multiscatter"])
def test_turntable_matches_jax(tmp_path, integrator):
    """render_turntable at 16^2, 3 frames, against the JAX package's: the
    sphere marcher (step 0.05, 2 environment samples) on the sphere
    scene, the Monte Carlo renderer (spp 4) on a 24-Gaussian scene (256-ray
    chunks, as the JAX package pads each chunk to the whole).  The
    decoded frames: mean |diff| below 2e-3, and below 2/255 on 99 % of the
    values (each package's palette is cut from its own float image, which
    the marcher matches at rtol 1e-4, the Monte Carlo renderer at
    testing.CHUNK_BARS)."""
    if integrator == "raymarch":
        text, jparse = SPHERES16, jax_parse_smm
        kw = dict(width=16, height=16, step_size=0.05, env_samples=2,
                  ray_chunk=256)
    else:
        text = random_gaussian_scene(24, seed=7, diameter=(0.2, 0.6),
                                     density=(0.5, 2.0))
        jparse = jax_parse_gmm
        kw = dict(width=16, height=16, spp=4, ray_chunk=256)
    jsc = jparse(text)
    jax_turntable(jsc, str(tmp_path / "j.gif"), JConfig(**kw), num_frames=3,
                  integrator=integrator, progress=None)
    lines = []
    render_turntable(port_scene(jsc), str(tmp_path / "t.gif"),
                     RenderConfig(**kw), num_frames=3,
                     integrator=integrator, progress=lines.append,
                     device="cpu")
    assert lines[-1] == "Frame 3 / 3 complete."
    got, want = _decoded(tmp_path / "t.gif"), _decoded(tmp_path / "j.gif")
    assert got.shape == want.shape == (3, 16, 16, 3) and got.std() > 0
    diff = np.abs(got - want)
    assert diff.mean() < 2e-3 and (diff <= 2 / 255 + 1e-6).mean() >= 0.99


# ---- the Mitsuba loader ---------------------------------------------------

# SURVEY §4.3's cross-check scene (the reference's
# tests/env_one_sphere_test_ortho.xml): orthographic sensor (0,1,6) ->
# (0,1,0) at 512^2, the sky-blue constant emitter, a point light at
# (0,4,0) of 35, one sphere of radius 1 at (0,1,0), sigma_t 0.8, albedo
# 0.875, which is the SMM text "s 0 1 0 1.0 0.1 0.7"
MITSUBA_XML = """<scene version="3.0.0">
  <integrator type="volpath"><integer name="max_depth" value="64"/></integrator>
  <sensor type="{sensor}">
    {fov}
    <transform name="to_world">
      <lookat origin="0, 1, 6" target="0, 1, 0" up="0, 1, 0"/>
    </transform>
    <film type="hdrfilm">
      <integer name="width" value="{w}"/>
      <integer name="height" value="{h}"/>
    </film>
  </sensor>
  <emitter type="constant"><rgb name="radiance" value="0.53, 0.81, 0.92"/></emitter>
  <emitter type="point">
    <point name="position" x="0" y="4" z="0"/>
    <rgb name="intensity" value="35"/>
  </emitter>
  <medium type="homogeneous" id="{medium}">
    <rgb name="albedo" value="0.875"/>
    <rgb name="sigma_t" value="0.8"/>
    <float name="scale" value="1"/>
  </medium>
  <shape type="sphere">
    <point name="center" x="0" y="1" z="0"/>
    <float name="radius" value="1"/>
    <bsdf type="null"/>
    <ref name="interior" id="sphere_medium"/>
  </shape>
</scene>
"""


def _xml(tmp_path, sensor="orthographic", fov="", w=512, h=512,
         medium="sphere_medium"):
    path = tmp_path / f"{sensor}_{medium}.xml"
    path.write_text(MITSUBA_XML.format(sensor=sensor, fov=fov, w=w, h=h,
                                       medium=medium))
    return str(path)


@pytest.mark.parametrize("sensor", ["orthographic", "perspective"])
def test_load_mitsuba_matches_jax(tmp_path, sensor):
    fov = '<float name="fov" value="30"/>' if sensor == "perspective" \
        else ""
    path = _xml(tmp_path, sensor, fov, 64, 48)
    scene, cam, w, h = load_mitsuba(path)
    jscene, jcam, jw, jh = jax_load_mitsuba(path)
    assert (w, h) == (jw, jh) == (64, 48)
    assert isinstance(cam, PinholeCamera if sensor == "perspective"
                      else OrthographicCamera)
    for k in ("position", "view_dir", "right", "up"):
        np.testing.assert_allclose(getattr(cam, k).numpy(),
                                   np.asarray(getattr(jcam, k)), atol=1e-7)
    if sensor == "perspective":
        assert cam.fov == pytest.approx(float(jcam.fov), rel=1e-7)
        assert cam.fov == pytest.approx(math.radians(30.0), rel=1e-6)
    for k in ("lights_p", "lights_i", "env_color"):
        assert np.array_equal(getattr(scene, k).numpy(),
                              np.asarray(getattr(jscene, k))), k
    for k in ("center", "radius", "sigma_a", "sigma_s"):
        assert np.array_equal(getattr(scene.medium, k).numpy(),
                              np.asarray(getattr(jscene.medium, k))), k
    # sigma_t 0.8 and albedo 0.875: sigma_a 0.1, sigma_s 0.7, the SMM twin
    twin = parse_smm("l 0 4 0  35 35 35\ns 0 1 0  1.0 0.1 0.7\n")
    for k in ("center", "radius", "sigma_a", "sigma_s"):
        assert np.array_equal(getattr(scene.medium, k).numpy(),
                              getattr(twin.medium, k).numpy()), k


def test_load_mitsuba_undefined_medium_raises(tmp_path):
    path = _xml(tmp_path, medium="other")
    with pytest.raises(ValueError, match="undefined medium id "
                       "'sphere_medium'.*'other'"):
        jax_load_mitsuba(path)
    with pytest.raises(ValueError, match="undefined medium id "
                       "'sphere_medium'.*'other'"):
        load_mitsuba(path)


def test_mitsuba_scene_renders_like_its_text_twin(tmp_path):
    """The XML scene and its SMM twin through the sphere marcher at 16^2
    give the same image (their float32 media are equal)."""
    scene, cam, _, _ = load_mitsuba(_xml(tmp_path, w=16, h=16))
    twin = parse_smm("l 0 4 0  35 35 35\ns 0 1 0  1.0 0.1 0.7\n")
    cfg = RenderConfig(width=16, height=16, step_size=0.05, env_samples=2)
    a = render_raymarch_spheres(scene, cam, cfg, device="cpu")
    b = render_raymarch_spheres(twin, cam, cfg, device="cpu")
    assert a.std() > 0 and np.array_equal(a, b)


# ---- the CLI --------------------------------------------------------------

@pytest.mark.parametrize("integrator", ["raymarch", "pureraymarch",
                                        "hitmask"])
def test_cli_renders_sphere_scene(tmp_path, integrator):
    """cli render of an SMM file writes the PPM of the integrator the JAX
    package's CLI routes it to (raymarch: the sphere marcher)."""
    scene = tmp_path / "spheres.txt"
    scene.write_text(SPHERES16)
    out = tmp_path / "out.ppm"
    stats = cli.main(["render", str(scene), "-o", str(out), "--width", "12",
                      "--height", "12", "--integrator", integrator,
                      "--step-size", "0.1", "--env-samples", "1", "--stats",
                      "--device", "cpu"])
    cam = PinholeCamera.create([0, 1, 6], [0, 1, 0], math.radians(45.0))
    render = {"raymarch": render_raymarch_spheres,
              "pureraymarch": render_pure_raymarch,
              "hitmask": render_hit_mask}[integrator]
    want = render(parse_smm(SPHERES16), cam,
                  RenderConfig(width=12, height=12, step_size=0.1,
                               env_samples=1), device="cpu")
    assert stats["integrator"] == integrator
    assert out.read_bytes() == b"P6\n12 12\n255\n" + ppm.quantize(
        want).tobytes()


def test_cli_render_voxel_npz(tmp_path, capsys):
    """tests/test_cli.py:73-96: a voxel .npz refuses multiscatter with the
    JAX package's message, which names pureraymarch, and renders with the
    pure marcher (raymarch too)."""
    npz = tmp_path / "vox.npz"
    sig = np.zeros((8, 8, 8), np.float32)
    sig[2:6, 2:6, 2:6] = 0.8
    np.savez(npz, sigma_t=sig, albedo=np.float32(0.7),
             lo=np.array([-1, 0, -1], np.float32),
             hi=np.array([1, 2, 1], np.float32),
             lights=np.array([[0, 4, 0, 35, 35, 35]], np.float32))
    out = tmp_path / "v.ppm"
    with pytest.raises(SystemExit, match="pureraymarch"):
        cli.main(["render", str(npz), "-o", str(out), "--width", "16",
                  "--height", "16", "--spp", "1", "--device", "cpu"])
    with pytest.raises(SystemExit, match="pureraymarch"):
        cli.main(["render", str(npz), "-o", str(out), "--integrator",
                  "hitmask", "--device", "cpu"])
    imgs = []
    for integrator in ("pureraymarch", "raymarch"):
        stats = cli.main(["render", str(npz), "-o", str(out), "--width",
                          "12", "--height", "12", "--integrator",
                          integrator, "--spp", "1", "--env-samples", "1",
                          "--step-size", "0.1", "--stats", "--device",
                          "cpu"])
        assert stats["integrator"] == "pureraymarch"
        imgs.append(ppm.read_ppm(str(out)))
    assert imgs[0].shape == (12, 12, 3) and np.isfinite(imgs[0]).all()
    assert imgs[0].std() > 0 and np.array_equal(imgs[0], imgs[1])
    assert "wrote" in capsys.readouterr().out


@pytest.mark.parametrize("integrator", ["raymarch", "multiscatter"])
def test_cli_animate(tmp_path, capsys, integrator):
    """tests/test_cli.py:42-48 on the CPU: cli animate of a one-Gaussian
    scene at 24^2, 2 frames, 1 environment sample (spp 2 for
    multiscatter) writes a GIF89a with a trailer; main returns the frames,
    seconds, path, bytes and backend; the orbit ignores --pos with a
    note."""
    scene = tmp_path / "scene.txt"
    scene.write_text("l 0 4 0  30 30 30\n"
                     "g 0 1 0  0.08 0.01 0  0.06 0 0.1  1.5 0.8\n")
    out = tmp_path / "a.gif"
    res = cli.main(["animate", str(scene), "-o", str(out), "--width", "24",
                    "--height", "24", "--frames", "2", "--env-samples", "1",
                    "--step-size", "0.05", "--spp", "2", "--integrator",
                    integrator, "--pos", "0", "2", "6", "--device", "cpu"])
    raw = out.read_bytes()
    assert raw.startswith(b"GIF89a") and raw.endswith(b"\x3b")
    assert int.from_bytes(raw[6:8], "little") == 24
    assert raw.count(b"\x2c\x00\x00\x00\x00") >= 2
    assert res["frames"] == 2 and res["path"] == str(out)
    assert res["bytes"] == len(raw) and res["backend"] == gif.last_backend
    printed = capsys.readouterr().out
    assert "GIF saved" in printed and "are ignored" in printed
    assert "Frame 2 / 2 complete." in printed
