"""State carried across from the JAX package as plain numpy arrays.

``scene_from_numpy`` takes the leaves of a ``gvr_tpu`` Scene and its
medium under their JAX field names (a GaussianMixture's, a
SphereMixture's or a VoxelGrid's, which ``spheres_from_numpy`` and
``voxels_from_numpy`` build); ``camera_from_numpy`` those of
a ``gvr_tpu`` camera; ``grid_from_numpy`` those of a ``gvr_tpu``
GridIndex; ``ray_gaussians_from_numpy`` those of a ``gvr_tpu``
RayGaussians, so both packages' solvers can run on one ray-Gaussian
state; ``params_from_numpy`` the flat 11-parameter vector (and the Adam
moments) of the inverse renderer.  The arrays are taken as they are (no eigh is recomputed), so
both packages pack bit-identical kernel tables from one scene.  Nothing here imports JAX: the caller converts with ``np.asarray``.
"""

from __future__ import annotations

import numpy as np
import torch

from gvr_tpu_torch.accel.grid import H, GridIndex, make_grid
from gvr_tpu_torch.cameras import OrthographicCamera, PinholeCamera
from gvr_tpu_torch.ops.transmittance import RayGaussians
from gvr_tpu_torch.scene.gaussians import GaussianMixture
from gvr_tpu_torch.scene.scene import Scene
from gvr_tpu_torch.scene.spheres import SphereMixture
from gvr_tpu_torch.scene.voxels import VoxelGrid

MIXTURE_FIELDS = ("mean", "cov", "density", "albedo", "emission",
                  "inv_cov", "norm", "eigvals", "eigvecs")
SPHERE_FIELDS = ("center", "radius", "sigma_a", "sigma_s")
VOXEL_FIELDS = ("lo", "hi", "sigma_t", "albedo")
SCENE_FIELDS = ("lights_p", "lights_i", "env_color")
CAMERA_FIELDS = ("position", "view_dir", "right", "up")
GRID_FIELDS = ("table", "cell_gfirst", "cell_gcnt", "lo", "cell",
               "inv_cell", "side", "s_cap", "n_entries")


def _t(x, device):
    return torch.tensor(np.asarray(x, np.float32), device=device)


def spheres_from_numpy(arrays: dict, device="cpu") -> SphereMixture:
    """SphereMixture from a dict keyed by SPHERE_FIELDS."""
    return SphereMixture(*(_t(arrays[k], device) for k in SPHERE_FIELDS))


def voxels_from_numpy(arrays: dict, device="cpu") -> VoxelGrid:
    """VoxelGrid from a dict keyed by VOXEL_FIELDS."""
    return VoxelGrid(*(_t(arrays[k], device) for k in VOXEL_FIELDS))


def scene_from_numpy(arrays: dict, device="cpu") -> Scene:
    """Scene from a dict of numpy arrays keyed by the JAX field names: a
    SphereMixture's where it has 'center', a VoxelGrid's where it has
    'sigma_t', else a GaussianMixture's."""
    if "center" in arrays:
        medium = spheres_from_numpy(arrays, device)
    elif "sigma_t" in arrays:
        medium = voxels_from_numpy(arrays, device)
    else:
        medium = GaussianMixture(*(_t(arrays[k], device)
                                   for k in MIXTURE_FIELDS))
    lp, li, env = (_t(arrays[k], device) for k in SCENE_FIELDS)
    return Scene(medium, lp.reshape(-1, 3), li.reshape(-1, 3),
                 env.reshape(3))


def params_from_numpy(params, device="cpu") -> torch.Tensor:
    """A flat float32 parameter vector [N*11] from numpy (a JAX package's
    ``pack_parameters`` or a checkpoint's array)."""
    return _t(params, device).reshape(-1)


def camera_from_numpy(arrays: dict, device="cpu"):
    """PinholeCamera when ``arrays`` has 'fov', else OrthographicCamera."""
    p, v, r, u = (_t(arrays[k], device).reshape(3) for k in CAMERA_FIELDS)
    if "fov" in arrays:
        return PinholeCamera(p, v, r, u, float(np.float32(arrays["fov"])))
    return OrthographicCamera(p, v, r, u)


def grid_from_numpy(arrays: dict, device="cpu") -> GridIndex:
    """GridIndex from a dict keyed by GRID_FIELDS (the JAX names).  The
    table keeps the cell-sorted entry rows of the JAX solve view, padded
    to a multiple of H as ``build_grid`` pads them; the span view is not
    carried."""
    n = int(arrays["n_entries"])
    rows = max(H, ((n + H - 1) // H) * H)
    table = np.asarray(arrays["table"], np.float32).reshape(-1, 16)[:rows]
    return make_grid(table, *(arrays[k] for k in GRID_FIELDS[1:]), device)


def ray_gaussians_from_numpy(arrays: dict, device="cpu") -> RayGaussians:
    """RayGaussians from a dict keyed by its field names (the JAX ones);
    ``hit`` becomes bool, the others float32."""
    return RayGaussians(*(
        torch.tensor(np.asarray(arrays[k], bool), device=device)
        if k == "hit" else _t(arrays[k], device)
        for k in RayGaussians._fields))
