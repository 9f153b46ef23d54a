"""Shared helpers of the tests/test_torch_*.py files.

Inputs are made with numpy from a seed and handed to both packages; JAX
objects cross over as numpy arrays (gvr_tpu_torch.scene.convert)."""

import math

import numpy as np
import pytest
import torch

from gvr_tpu_torch.cameras import PinholeCamera
from gvr_tpu_torch.scene.convert import (CAMERA_FIELDS, MIXTURE_FIELDS,
                                         SCENE_FIELDS, SPHERE_FIELDS,
                                         VOXEL_FIELDS, camera_from_numpy,
                                         scene_from_numpy)
from gvr_tpu_torch.testing import bounce_agreement

# Tier-1 runs several xdist workers on a few cores.
torch.set_num_threads(1)


def scene_arrays(sc) -> dict:
    """gvr_tpu Scene (any medium) -> numpy arrays under the JAX field
    names."""
    fields = (SPHERE_FIELDS if hasattr(sc.medium, "center") else
              VOXEL_FIELDS if hasattr(sc.medium, "sigma_t") else
              MIXTURE_FIELDS)
    out = {k: np.asarray(getattr(sc.medium, k)) for k in fields}
    out.update({k: np.asarray(getattr(sc, k)) for k in SCENE_FIELDS})
    return out


def port_scene(sc, device="cpu"):
    return scene_from_numpy(scene_arrays(sc), device)


def port_camera(cam, device="cpu"):
    arrays = {k: np.asarray(getattr(cam, k)) for k in CAMERA_FIELDS}
    if hasattr(cam, "fov"):
        arrays["fov"] = np.asarray(cam.fov)
    return camera_from_numpy(arrays, device)


def random_rays(n: int, seed: int):
    """(o [n,3], d [n,3], xi [n,9]) float32 numpy rays around the scenes'
    [-1,1]x[0,2]x[-1,1] box, like test_pallas_kernels._random_rays."""
    rng = np.random.default_rng(seed)
    o = (rng.uniform(-1.5, 1.5, (n, 3)) + [0.0, 1.0, 1.5]).astype(np.float32)
    d = rng.normal(size=(n, 3))
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    xi = rng.uniform(size=(n, 9)).astype(np.float32)
    return o, d, xi


def check_bounce(outs, refs) -> dict:
    """Assert the bars of tests/test_pallas_kernels.py:_check
    (gvr_tpu_torch.testing.BOUNCE_BARS) and return the measured
    agreement."""
    res = bounce_agreement(outs, refs)
    assert res["ok"], res
    return res


@pytest.fixture
def cuda_device():
    """The first CUDA device; skips the test where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (torch.cuda.is_available() is false)")
    return torch.device("cuda", 0)


def box_rays(medium, kind: str, n: int = 768, seed: int = 0):
    """(o, d, tmax or None) of one kind: camera rays over the whole 512^2
    image; rays from inside the box of the means; NEE segments from inside
    points to the generator's 3 lights (tmax their distance) or in random
    directions (tmax 0.02-1.5); rays along an axis or in an axis plane."""
    r = np.random.default_rng(seed)
    mean = medium.mean.numpy()
    inside = r.uniform(mean.min(0), mean.max(0), (n, 3))
    dirs = r.normal(size=(n, 3))
    tmax = None
    if kind == "camera":
        cam = PinholeCamera.create([0, 1, 6], [0, 1, 0], math.radians(45.0))
        o, d = cam.sample_ray(torch.tensor(r.uniform(size=(n, 2)),
                                           dtype=torch.float32))
        return o, d.contiguous(), None
    if kind == "nee":
        lights = np.array([[0.0, 5.0, 0.1], [-3.0, 3.0, 0.3],
                           [3.0, 3.0, -0.2]])
        to = lights[r.integers(0, 3, n)] - inside
        dist = np.linalg.norm(to, axis=1)
        env = r.uniform(size=n) < 0.5
        dirs = np.where(env[:, None], dirs, to)
        tmax = np.where(env, r.uniform(0.02, 1.5, n), dist)
    if kind == "axis":
        dirs = np.zeros((n, 3))
        dirs[np.arange(n), r.integers(0, 3, n)] = r.choice([-1.0, 1.0], n)
        half = n // 2
        dirs[half:] = r.normal(size=(n - half, 3))
        dirs[np.arange(half, n), r.integers(0, 3, n - half)] = 0.0
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    f32 = lambda a: torch.tensor(a, dtype=torch.float32)
    return f32(inside), f32(dirs), None if tmax is None else f32(tmax)
