"""Cameras as functions uv -> (origin, direction), batched over pixels.

Counterpart of ``gvr_tpu/cameras.py`` (reference ``include/camera.h``), with
the same frame and the same parity-critical flips:

* frame: right = view_dir x world_up, up = right x view_dir (camera.h:15-22),
  with the z-axis fallback when looking straight up or down;
* pinhole: image plane AT ``position``, pinhole point at
  position + view_dir / tan(fov/2); u is x-flipped, u = 1 - 2 uv.x
  (camera.h:45-53);
* orthographic: parallel rays along view_dir; v is y-flipped,
  v = 1 - 2 uv.y (camera.h:64-73).
"""

from __future__ import annotations

import dataclasses

import torch

WORLD_UP = (0.0, 1.0, 0.0)


def _normalize(v: torch.Tensor) -> torch.Tensor:
    return v / torch.linalg.vector_norm(v, dim=-1, keepdim=True)


def make_frame(position, view_dir, device="cpu"):
    """(position, view_dir, right, up), each a float32 [3] tensor."""
    f32 = dict(dtype=torch.float32, device=device)
    position = torch.as_tensor(position, **f32)
    view_dir = _normalize(torch.as_tensor(view_dir, **f32))
    r = torch.linalg.cross(view_dir, torch.tensor(WORLD_UP, **f32))
    if float(torch.linalg.vector_norm(r)) < 1e-6:
        r = torch.linalg.cross(view_dir, torch.tensor((0.0, 0.0, 1.0), **f32))
    right = _normalize(r)
    up = _normalize(torch.linalg.cross(right, view_dir))
    return position, view_dir, right, up


def camera_rays(position, right, up, view_dir, focal, uv: torch.Tensor):
    """uv [...,2] in [0,1] -> (origin [...,3], direction [...,3]): the one
    copy of the ray math, shared by both cameras' ``sample_ray`` and the
    megakernel's plain version.  ``focal`` is 1/tan(fov/2) for a pinhole
    camera and None for an orthographic one."""
    if focal is None:
        u = uv[..., 0] * 2.0 - 1.0
        v = 1.0 - uv[..., 1] * 2.0          # y-flip (camera.h:67)
    else:
        u = 1.0 - uv[..., 0] * 2.0          # x-flip (camera.h:47)
        v = uv[..., 1] * 2.0 - 1.0
    origin = position + u[..., None] * right + v[..., None] * up
    if focal is None:
        return origin, view_dir.expand_as(origin)
    return origin, _normalize(position + focal * view_dir - origin)


@dataclasses.dataclass
class PinholeCamera:
    position: torch.Tensor
    view_dir: torch.Tensor
    right: torch.Tensor
    up: torch.Tensor
    fov: float                  # radians, a float32 value

    @staticmethod
    def create(position, lookat_or_dir, fov, lookat=True,
               device="cpu") -> "PinholeCamera":
        f32 = dict(dtype=torch.float32, device=device)
        position = torch.as_tensor(position, **f32)
        target = torch.as_tensor(lookat_or_dir, **f32)
        view = target - position if lookat else target
        p, v, r, u = make_frame(position, view, device)
        return PinholeCamera(p, v, r, u, float(torch.tensor(fov, **f32)))

    def focal(self) -> torch.Tensor:
        """1 / tan(fov/2) as a float32 scalar tensor."""
        fov = torch.tensor(self.fov, dtype=torch.float32,
                           device=self.position.device)
        return 1.0 / torch.tan(0.5 * fov)

    def to(self, device) -> "PinholeCamera":
        return PinholeCamera(self.position.to(device),
                             self.view_dir.to(device), self.right.to(device),
                             self.up.to(device), self.fov)

    def sample_ray(self, uv: torch.Tensor):
        """uv [...,2] in [0,1] -> (origin [...,3], direction [...,3])."""
        return camera_rays(self.position, self.right, self.up,
                           self.view_dir, self.focal(), uv)


@dataclasses.dataclass
class OrthographicCamera:
    position: torch.Tensor
    view_dir: torch.Tensor
    right: torch.Tensor
    up: torch.Tensor

    @staticmethod
    def create(position, lookat_or_dir, lookat=True,
               device="cpu") -> "OrthographicCamera":
        f32 = dict(dtype=torch.float32, device=device)
        position = torch.as_tensor(position, **f32)
        target = torch.as_tensor(lookat_or_dir, **f32)
        view = target - position if lookat else target
        return OrthographicCamera(*make_frame(position, view, device))

    def to(self, device) -> "OrthographicCamera":
        return OrthographicCamera(self.position.to(device),
                                  self.view_dir.to(device),
                                  self.right.to(device), self.up.to(device))

    def sample_ray(self, uv: torch.Tensor):
        """Parallel rays along view_dir; v is y-flipped (camera.h:67)."""
        return camera_rays(self.position, self.right, self.up,
                           self.view_dir, None, uv)


def pixel_center_uv(width: int, height: int, device="cpu") -> torch.Tensor:
    """uv at the pixel centres, ((x + 0.5) / W, (y + 0.5) / H), as
    [H, W, 2] float32: the deterministic integrators' sampling
    (integrator.h:77-78)."""
    f32 = dict(dtype=torch.float32, device=device)
    xs = (torch.arange(width, **f32) + 0.5) / width
    ys = (torch.arange(height, **f32) + 0.5) / height
    v, u = torch.meshgrid(ys, xs, indexing="ij")
    return torch.stack([u, v], dim=-1)
