"""Scene container and the GMM text-format loader.

Counterpart of ``gvr_tpu/scene/scene.py`` (reference ``include/scene.h``).
The text format (scene.h:38-120):

    Light:    l x y z  r g b
    Gaussian: g x y z  cxx cxy cxz cyy cyz czz  density albedo [er eg eb]
    Sphere:   s x y z  radius sigma_a sigma_s

Lines with other leading tokens are skipped, and each line's floats are read
as a greedy prefix (trailing junk ignored), the same rules as the JAX
package's ``_parse_lines``.  Sphere, voxel and VDB media wait for their port
(ROADMAP Queue 1, spheres/voxels) and raise.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Union

import numpy as np
import torch

from gvr_tpu_torch.scene.gaussians import GaussianMixture

DEFAULT_ENV_COLOR = (0.53, 0.81, 0.92)


@dataclasses.dataclass
class Scene:
    """Medium + point lights + environment radiance.

    lights_p [L,3] and lights_i [L,3] float32; env_color [3] float32.
    """

    medium: GaussianMixture
    lights_p: torch.Tensor
    lights_i: torch.Tensor
    env_color: torch.Tensor

    @property
    def num_lights(self) -> int:
        return self.lights_p.shape[0]

    def with_medium(self, medium: GaussianMixture) -> "Scene":
        """This scene's lights and environment around another medium."""
        return Scene(medium, self.lights_p, self.lights_i, self.env_color)

    def to(self, device) -> "Scene":
        return Scene(self.medium.to(device), self.lights_p.to(device),
                     self.lights_i.to(device), self.env_color.to(device))

    def lights(self) -> torch.Tensor:
        """[L,6] rows (position xyz, intensity rgb), the kernels' layout."""
        return torch.cat([self.lights_p, self.lights_i], dim=1).contiguous()


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
    lt = torch.as_tensor(np.asarray(lights, np.float32).reshape(-1, 6),
                         device=device)
    env = torch.as_tensor(env_color, dtype=torch.float32, device=device)
    return Scene(gmm, lt[:, 0:3].contiguous(), lt[:, 3:6].contiguous(),
                 env.reshape(3))


def load_gmm(path: Union[str, os.PathLike], env_color=DEFAULT_ENV_COLOR,
             device="cpu") -> Scene:
    """Load a Gaussian scene file (scene.h:72-120)."""
    return parse_gmm(_read_text(path), env_color, device)


def load_scene(path: Union[str, os.PathLike], env_color=None,
               device="cpu") -> Scene:
    """Load a text scene with 'g' lines.  Sphere scenes, voxel grids
    (.npz) and VDB files are not ported yet and raise."""
    if str(path).endswith((".npz", ".vdb")):
        raise NotImplementedError(
            f"{path}: voxel and VDB media are not ported yet (ROADMAP "
            f"Queue 1, spheres/voxels)")
    if env_color is None:
        env_color = DEFAULT_ENV_COLOR
    text = _read_text(path)
    tags = {tag for tag, _ in _parse_lines(text)}
    if "g" in tags:
        return parse_gmm(text, env_color, device)
    if "s" in tags:
        raise NotImplementedError(
            f"{path}: sphere (SMM) scenes are not ported yet (ROADMAP "
            f"Queue 1, spheres/voxels)")
    raise ValueError(f"No primitives found in scene file: {path}")
