"""Dense voxel-grid medium and its .npz loader.

Counterpart of ``gvr_tpu/scene/voxels.py`` (the reference declares
``VolumeType::VOXELS`` and a ``load_VDB`` stub and implements neither,
scene.h:21-22, 122, 144-145; the JAX package makes the type real): a
cell-centred ``sigma_t``/``albedo`` grid over an AABB with trilinear
interpolation, rendered by the medium-agnostic pure marcher
(``integrators/raymarch.render_pure_raymarch``).  ``from_gaussians`` bakes
a GaussianMixture into a grid on the mixture's device, the JAX package's
cross-representation check: a medium and its bake, through one marcher,
give the same image as the resolution rises.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch


@dataclasses.dataclass
class VoxelGrid:
    """Cell-centred dense medium over the AABB [lo, hi].

    lo [3], hi [3], sigma_t [X,Y,Z] extinction and albedo [X,Y,Z]
    single-scattering albedo, float32.  Samples sit at the cell centres;
    interpolation is trilinear with clamp-to-edge (the AABB still bounds
    the medium: the clamp only shapes the outermost half-cell band).
    """

    lo: torch.Tensor
    hi: torch.Tensor
    sigma_t: torch.Tensor
    albedo: torch.Tensor

    @staticmethod
    def create(lo, hi, sigma_t, albedo=0.9, device="cpu") -> "VoxelGrid":
        """Build on ``device``; a scalar albedo fills the grid."""
        f32 = dict(dtype=torch.float32, device=device)
        sigma_t = torch.as_tensor(sigma_t, **f32)
        if sigma_t.dim() != 3:
            raise ValueError("sigma_t must be [X,Y,Z]")
        albedo = torch.as_tensor(albedo, **f32)
        if albedo.dim() == 0:
            albedo = albedo.expand(sigma_t.shape).contiguous()
        if albedo.shape != sigma_t.shape:
            raise ValueError(f"albedo {tuple(albedo.shape)} does not match "
                             f"sigma_t {tuple(sigma_t.shape)}")
        return VoxelGrid(torch.as_tensor(lo, **f32).reshape(3),
                         torch.as_tensor(hi, **f32).reshape(3), sigma_t,
                         albedo)

    # -- the medium protocol of the marchers ----------------------------------

    @property
    def n(self) -> int:
        """The per-ray working set for the chunk choice: a trilinear sample
        is O(1) at any resolution."""
        return 1

    @property
    def res(self):
        return tuple(self.sigma_t.shape)

    def to(self, device) -> "VoxelGrid":
        return VoxelGrid(*(getattr(self, f.name).to(device)
                           for f in dataclasses.fields(self)))

    def aabbs(self):
        """([1,3] min, [1,3] max): the grid is one bounded primitive."""
        return self.lo[None, :], self.hi[None, :]

    def intersect(self, origin, direction):
        """Slab test of rays [..., 3] against the grid's AABB: (t_enter,
        t_exit, hit), each [..., 1], so they plug into the marchers'
        per-primitive active mask."""
        tiny = torch.where(direction >= 0, 1e-12, -1e-12)
        inv = 1.0 / torch.where(direction.abs() > 1e-12, direction, tiny)
        a = (self.lo - origin) * inv
        b = (self.hi - origin) * inv
        t0 = torch.amax(torch.minimum(a, b), dim=-1)
        t1 = torch.amin(torch.maximum(a, b), dim=-1)
        hit = (t0 <= t1) & (t1 >= 0.0)
        return t0[..., None], t1[..., None], hit[..., None]

    def _trilinear(self, grid: torch.Tensor, x: torch.Tensor):
        """Trilinear sample of grid [X,Y,Z] (or [X,Y,Z,C], C channels at
        once) at world points x [..., 3] -> [...] (or [..., C]), in the JAX
        package's order of rounding: f = (x - lo) / (hi - lo) * res - 0.5
        clipped to [0, res - 1], i0 = floor(f) clipped to res - 2, then
        lerps along z, y and x."""
        shape = grid.shape[:3]
        res = torch.tensor(shape, dtype=torch.float32, device=x.device)
        f = (x - self.lo) / (self.hi - self.lo) * res - 0.5
        f = torch.minimum(torch.clamp(f, min=0.0), res - 1.0)
        i0 = torch.minimum(torch.clamp(torch.floor(f).to(torch.int64),
                                       min=0),
                           torch.tensor(shape, device=x.device) - 2)
        w = f - i0.to(torch.float32)
        sy, sx = shape[2], shape[1] * shape[2]
        base = i0[..., 0] * sx + i0[..., 1] * sy + i0[..., 2]
        flat = grid.reshape(sx * shape[0], *grid.shape[3:])
        if grid.dim() == 4:
            w = w[..., None, :]
        wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
        ux, uy, uz = 1 - wx, 1 - wy, 1 - wz

        def g(dx, dy, dz):
            return flat[base + (dx * sx + dy * sy + dz)]

        c00 = g(0, 0, 0) * uz + g(0, 0, 1) * wz
        c01 = g(0, 1, 0) * uz + g(0, 1, 1) * wz
        c10 = g(1, 0, 0) * uz + g(1, 0, 1) * wz
        c11 = g(1, 1, 0) * uz + g(1, 1, 1) * wz
        c0 = c00 * uy + c01 * wy
        c1 = c10 * uy + c11 * wy
        return c0 * ux + c1 * wx

    @functools.cached_property
    def _channels(self) -> torch.Tensor:
        """[X,Y,Z,2]: sigma_t and the albedo side by side, for one gather a
        corner."""
        return torch.stack([self.sigma_t, self.albedo], dim=-1)

    def sigma_albedo(self, x, active_mask):
        """(sigma_a, sigma_s) at points x [..., 3] under the AABB's active
        mask [..., 1], the contract of ``GaussianMixture.sigma_albedo``
        (gmm.h:98-126); both grids are sampled in one pass."""
        both = self._trilinear(self._channels, x)
        st = both[..., 0] * active_mask[..., 0]
        a = both[..., 1]
        return (1.0 - a) * st, a * st

    # -- construction ----------------------------------------------------------

    @staticmethod
    def from_gaussians(gmm, res: int = 64, pad: float = 0.05,
                       chunk: int = 8192) -> "VoxelGrid":
        """Bake a GaussianMixture into a res^3 grid on the mixture's device,
        ``chunk`` cell centres at a time: sigma_t(x) = sum_i mu_t_i(x)
        (``GaussianMixture.mu_t``), the albedo the extinction-weighted blend
        (gmm.h:98-126), or the mixture's mean albedo where the field is at
        most 1e-25 (a filler that interpolates safely).  The box is the
        Gaussians' R_CUT AABBs grown by ``pad``, in float64 on the host, as
        the JAX package sets it; the AABBs are computed on the CPU, so a
        bake on the card samples the CPU's (and the JAX package's) cell
        centres."""
        device = gmm.mean.device
        bmin, bmax = (a.detach().numpy().astype(np.float64)
                      for a in gmm.to("cpu").aabbs())
        lo = bmin.min(axis=0) - pad
        hi = bmax.max(axis=0) + pad
        cell = (hi - lo) / res
        axes = [lo[k] + (np.arange(res) + 0.5) * cell[k] for k in range(3)]
        pts = torch.from_numpy(np.stack(np.meshgrid(*axes, indexing="ij"),
                                        axis=-1).reshape(-1, 3)
                               .astype(np.float32)).to(device)
        mean_albedo = float(gmm.albedo.detach().cpu().numpy().mean())
        st = torch.empty(pts.shape[0], dtype=torch.float32, device=device)
        al = torch.empty_like(st)
        with torch.no_grad():
            for start in range(0, pts.shape[0], chunk):
                mt = gmm.mu_t(pts[start:start + chunk])          # [B,N]
                s = torch.sum(mt, dim=-1)
                sa = torch.sum(mt * gmm.albedo, dim=-1)
                some = s > 1e-25
                st[start:start + chunk] = s
                al[start:start + chunk] = torch.where(
                    some, sa / torch.where(some, s, 1.0), mean_albedo)
        shape = (res, res, res)
        return VoxelGrid.create(lo, hi, st.reshape(shape), al.reshape(shape),
                                device=device)


def load_voxels(path, env_color=None, device="cpu"):
    """A voxel Scene on ``device`` from an .npz file.

    Keys: ``sigma_t`` [X,Y,Z] (required); optional ``albedo`` (a scalar
    or [X,Y,Z], default 0.9), ``lo``/``hi`` [3] (default the unit cube),
    ``lights`` [L,6] (position and intensity rows) and ``env_color`` [3],
    which an ``env_color`` argument overrides.
    """
    from gvr_tpu_torch.scene.scene import DEFAULT_ENV_COLOR, make_scene
    data = np.load(path)
    if "sigma_t" not in data:
        raise ValueError(f"voxel scene {path} lacks 'sigma_t' [X,Y,Z]")
    albedo = data["albedo"] if "albedo" in data else 0.9
    lo = data["lo"] if "lo" in data else np.zeros(3, np.float32)
    hi = data["hi"] if "hi" in data else np.ones(3, np.float32)
    lights = data["lights"] if "lights" in data else np.zeros((0, 6))
    if env_color is None:
        env_color = (tuple(data["env_color"]) if "env_color" in data
                     else DEFAULT_ENV_COLOR)
    grid = VoxelGrid.create(lo, hi, data["sigma_t"], albedo, device=device)
    return make_scene(grid, lights, env_color, device)
