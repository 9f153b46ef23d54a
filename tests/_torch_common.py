"""Shared helpers of the tests/test_torch_*.py files.

Inputs are made with numpy from a seed and handed to both packages; JAX
objects cross over as numpy arrays (gvr_tpu_torch.scene.convert)."""

import numpy as np
import pytest
import torch

from gvr_tpu_torch.scene.convert import (CAMERA_FIELDS, MIXTURE_FIELDS,
                                         SCENE_FIELDS, camera_from_numpy,
                                         scene_from_numpy)
from gvr_tpu_torch.testing import bounce_agreement

# Tier-1 runs several xdist workers on a few cores.
torch.set_num_threads(1)


def scene_arrays(sc) -> dict:
    """gvr_tpu Scene -> numpy arrays under the JAX field names."""
    out = {k: np.asarray(getattr(sc.medium, k)) for k in MIXTURE_FIELDS}
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
