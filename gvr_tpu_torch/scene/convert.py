"""State carried across from the JAX package as plain numpy arrays.

``scene_from_numpy`` takes the leaves of a ``gvr_tpu`` Scene and its
GaussianMixture under their JAX field names; ``camera_from_numpy`` those of
a ``gvr_tpu`` camera.  The arrays are taken as they are (no eigh is
recomputed), so both packages pack bit-identical kernel tables from one
scene.  Nothing here imports JAX: the caller converts with ``np.asarray``.
"""

from __future__ import annotations

import numpy as np
import torch

from gvr_tpu_torch.cameras import OrthographicCamera, PinholeCamera
from gvr_tpu_torch.scene.gaussians import GaussianMixture
from gvr_tpu_torch.scene.scene import Scene

MIXTURE_FIELDS = ("mean", "cov", "density", "albedo", "emission",
                  "inv_cov", "norm", "eigvals", "eigvecs")
SCENE_FIELDS = ("lights_p", "lights_i", "env_color")
CAMERA_FIELDS = ("position", "view_dir", "right", "up")


def _t(x, device):
    return torch.tensor(np.asarray(x, np.float32), device=device)


def scene_from_numpy(arrays: dict, device="cpu") -> Scene:
    """Scene from a dict of numpy arrays keyed by the JAX field names."""
    gmm = GaussianMixture(*(_t(arrays[k], device) for k in MIXTURE_FIELDS))
    lp, li, env = (_t(arrays[k], device) for k in SCENE_FIELDS)
    return Scene(gmm, lp.reshape(-1, 3), li.reshape(-1, 3), env.reshape(3))


def camera_from_numpy(arrays: dict, device="cpu"):
    """PinholeCamera when ``arrays`` has 'fov', else OrthographicCamera."""
    p, v, r, u = (_t(arrays[k], device).reshape(3) for k in CAMERA_FIELDS)
    if "fov" in arrays:
        return PinholeCamera(p, v, r, u, float(np.float32(arrays["fov"])))
    return OrthographicCamera(p, v, r, u)
