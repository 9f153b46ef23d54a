"""The CUDA kernels against their plain versions on the card.

Every test here needs a CUDA card and skips without one.  The file imports
neither JAX nor gvr_tpu, so on a machine with a card and no JAX it runs as

    python -m pytest tests/test_torch_cuda.py -m gpu --noconftest -q

(--noconftest: tests/conftest.py sets up JAX for the rest of the suite)."""

import math

import numpy as np
import pytest
import torch

from _torch_common import check_bounce, cuda_device, random_rays  # noqa: F401
from gvr_tpu_torch.cameras import OrthographicCamera, PinholeCamera
from gvr_tpu_torch.config import RenderConfig
from gvr_tpu_torch.integrators.multiscatter import render_multiscatter
from gvr_tpu_torch.kernels import megatrace as tmt
from gvr_tpu_torch.kernels import pathtrace as tpt
from gvr_tpu_torch.kernels import rng as trng
from gvr_tpu_torch.scene.generators import random_gaussian_scene
from gvr_tpu_torch.scene.scene import parse_gmm
from gvr_tpu_torch.testing import mega_agreement

pytestmark = pytest.mark.gpu

# 24 Gaussians under the generator's 3 point lights
SCENE24 = random_gaussian_scene(24, seed=7, diameter=(0.2, 0.6),
                                density=(0.5, 2.0))
MEGA_KW = dict(width=16, height=16, spp=9, max_bounces=6)


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
