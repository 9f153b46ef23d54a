"""Scene container and the text-format loaders.

Counterpart of ``gvr_tpu/scene/scene.py`` (reference ``include/scene.h``).
The text format (scene.h:38-120):

    Light:    l x y z  r g b
    Gaussian: g x y z  cxx cxy cxz cyy cyz czz  density albedo [er eg eb]
    Sphere:   s x y z  radius sigma_a sigma_s

Lines with other leading tokens are skipped, and each line's floats are read
as a greedy prefix (trailing junk ignored), the same rules as the JAX
package's ``_parse_lines``.  ``load_scene`` takes a text scene with 'g'
lines as a GaussianMixture, one with 's' lines as a SphereMixture, and an
.npz as a VoxelGrid (``scene/voxels.load_voxels``); OpenVDB files raise,
as in the JAX package.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Union

import numpy as np
import torch

from gvr_tpu_torch.scene.gaussians import GaussianMixture
from gvr_tpu_torch.scene.spheres import SphereMixture

DEFAULT_ENV_COLOR = (0.53, 0.81, 0.92)

# The integrators that render each non-Gaussian medium (`cli render`
# sends a voxel scene's raymarch to the pure marcher).
OTHER_MEDIA_INTEGRATORS = {
    "SphereMixture": "raymarch, pureraymarch and hitmask",
    "VoxelGrid": "pureraymarch (cli render's raymarch too) and hitmask"}


@dataclasses.dataclass
class Scene:
    """Medium + point lights + environment radiance.

    ``medium`` is a GaussianMixture, a SphereMixture or a VoxelGrid;
    lights_p [L,3] and lights_i [L,3] float32; env_color [3] float32.
    """

    medium: object
    lights_p: torch.Tensor
    lights_i: torch.Tensor
    env_color: torch.Tensor

    @property
    def num_lights(self) -> int:
        return self.lights_p.shape[0]

    @property
    def is_gaussian(self) -> bool:
        return isinstance(self.medium, GaussianMixture)

    def require_gaussian(self, what: str) -> None:
        """Raise a TypeError naming the integrators that render this
        scene's medium unless it is a GaussianMixture (``what``, e.g.
        render_multiscatter, takes Gaussian media only, as in the JAX
        package)."""
        if not self.is_gaussian:
            kind = type(self.medium).__name__
            raise TypeError(
                f"{what} renders Gaussian media only; a {kind} renders "
                f"with {OTHER_MEDIA_INTEGRATORS.get(kind, 'none')}")

    def with_medium(self, medium) -> "Scene":
        """This scene's lights and environment around another medium."""
        return Scene(medium, self.lights_p, self.lights_i, self.env_color)

    def to(self, device) -> "Scene":
        return Scene(self.medium.to(device), self.lights_p.to(device),
                     self.lights_i.to(device), self.env_color.to(device))

    def lights(self) -> torch.Tensor:
        """[L,6] rows (position xyz, intensity rgb), the kernels' layout."""
        return torch.cat([self.lights_p, self.lights_i], dim=1).contiguous()


def make_scene(medium, lights, env_color, device="cpu") -> Scene:
    """A Scene of ``medium`` with light rows [L,6] (position, intensity)
    and an env_color [3] on ``device``."""
    lt = torch.as_tensor(np.asarray(lights, np.float32).reshape(-1, 6),
                         device=device)
    env = torch.as_tensor(np.asarray(env_color, np.float32), device=device)
    return Scene(medium, lt[:, 0:3].contiguous(), lt[:, 3:6].contiguous(),
                 env.reshape(3))


def _parse_lines(text: str):
    """Yield (tag, floats) per line whose tag is l/g/s; skip the rest."""
    for line in text.splitlines():
        parts = line.split()
        if not parts or parts[0] not in ("l", "g", "s"):
            continue
        vals = []
        for v in parts[1:]:
            try:
                vals.append(float(v))
            except ValueError:
                break
        yield parts[0], vals


def _read_text(path: Union[str, os.PathLike]) -> str:
    p = str(path)
    if not os.path.exists(p):
        raise FileNotFoundError(f"Failed to open scene file: {p}")
    with open(p, "r") as f:
        return f.read()


# Above this many Gaussians the parser Morton-sorts the mixture
# (gvr_tpu/scene/scene.py:173-176).
MORTON_MIN_N = 512


def parse_gmm(text: str, env_color=DEFAULT_ENV_COLOR,
              device="cpu") -> Scene:
    """Parse GMM scene text into a Scene on ``device``; above
    MORTON_MIN_N Gaussians in Morton order, as the JAX package parses
    it."""
    lights, means, covs, dens, albs, emis = [], [], [], [], [], []
    for tag, v in _parse_lines(text):
        if tag == "l" and len(v) >= 6:
            lights.append(v[0:6])
        elif tag == "g" and len(v) >= 11:
            means.append(v[0:3])
            cxx, cxy, cxz, cyy, cyz, czz = v[3:9]
            covs.append([[cxx, cxy, cxz], [cxy, cyy, cyz], [cxz, cyz, czz]])
            dens.append(v[9])
            albs.append(v[10])
            emis.append(v[11:14] if len(v) >= 14 else [0.0, 0.0, 0.0])
    gmm = GaussianMixture.from_covariances(
        np.asarray(means, np.float32), np.asarray(covs, np.float32),
        np.asarray(dens, np.float32), np.asarray(albs, np.float32),
        np.asarray(emis, np.float32), device=device)
    if gmm.n > MORTON_MIN_N:
        gmm = gmm.morton_sorted()
    return make_scene(gmm, lights, env_color, device)


def load_gmm(path: Union[str, os.PathLike], env_color=DEFAULT_ENV_COLOR,
             device="cpu") -> Scene:
    """Load a Gaussian scene file (scene.h:72-120)."""
    return parse_gmm(_read_text(path), env_color, device)


def parse_smm(text: str, env_color=DEFAULT_ENV_COLOR,
              device="cpu") -> Scene:
    """Parse SMM scene text ('s x y z radius sigma_a sigma_s' lines)
    into a Scene on ``device``."""
    lights, spheres = [], []
    for tag, v in _parse_lines(text):
        if tag == "l" and len(v) >= 6:
            lights.append(v[0:6])
        elif tag == "s" and len(v) >= 6:
            spheres.append(v[0:6])
    s = np.asarray(spheres, np.float32).reshape(-1, 6)
    smm = SphereMixture.create(s[:, 0:3], s[:, 3], s[:, 4], s[:, 5],
                               device=device)
    return make_scene(smm, lights, env_color, device)


def load_smm(path: Union[str, os.PathLike], env_color=DEFAULT_ENV_COLOR,
             device="cpu") -> Scene:
    """Load a sphere scene file (scene.h:38-68)."""
    return parse_smm(_read_text(path), env_color, device)


def load_vdb(path: Union[str, os.PathLike]) -> Scene:
    """OpenVDB files are not read, as in the reference (scene.h:21-22,
    122, 144-145) and the JAX package: convert them to an .npz grid."""
    raise NotImplementedError(
        "OpenVDB parsing not supported; convert to .npz (sigma_t [X,Y,Z]) "
        "and use gvr_tpu_torch.scene.voxels.load_voxels")


def load_scene(path: Union[str, os.PathLike], env_color=None,
               device="cpu") -> Scene:
    """Load a scene on ``device``: an .npz is a voxel grid
    (``load_voxels``), a .vdb raises (``load_vdb``), and a text scene with
    'g' lines is a GMM, else one with 's' lines an SMM.  ``env_color=None``
    means the file's env_color where an .npz has one, else the
    reference's default."""
    if str(path).endswith(".npz"):
        from gvr_tpu_torch.scene.voxels import load_voxels
        return load_voxels(path, env_color, device)
    if str(path).endswith(".vdb"):
        return load_vdb(path)
    if env_color is None:
        env_color = DEFAULT_ENV_COLOR
    text = _read_text(path)
    tags = {tag for tag, _ in _parse_lines(text)}
    if "g" in tags:
        return parse_gmm(text, env_color, device)
    if "s" in tags:
        return parse_smm(text, env_color, device)
    raise ValueError(f"No primitives found in scene file: {path}")
