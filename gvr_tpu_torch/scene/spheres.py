"""Homogeneous-sphere mixture medium as structure-of-arrays tensors.

Counterpart of ``gvr_tpu/scene/spheres.py`` (reference ``Sphere`` and
``SphereMixtureModel``, ``include/smm.h``).  Each sphere has a constant
sigma_a and sigma_s inside its radius, so transmittance is a piecewise
exponential of the overlap lengths: a sum over clipped intervals, with no
event sort.
"""

from __future__ import annotations

import dataclasses

import torch


def _dot3(u, v, fused: bool) -> torch.Tensor:
    """u . v over the last axis of [..., 3] tensors in index order, as a
    chain of fused multiply-adds (``fused``) or of products and sums, the
    two forms XLA's CPU code gives the JAX package's einsums; no matmul,
    so no TF32."""
    out = u[..., 0] * v[..., 0]
    for i in (1, 2):
        out = (torch.addcmul(out, u[..., i], v[..., i]) if fused
               else out + u[..., i] * v[..., i])
    return out


@dataclasses.dataclass
class SphereMixture:
    """center [N,3], radius [N], sigma_a [N], sigma_s [N], float32."""

    center: torch.Tensor
    radius: torch.Tensor
    sigma_a: torch.Tensor
    sigma_s: torch.Tensor

    @staticmethod
    def create(center, radius, sigma_a, sigma_s,
               device="cpu") -> "SphereMixture":
        f32 = dict(dtype=torch.float32, device=device)
        center = torch.as_tensor(center, **f32).reshape(-1, 3)
        n = center.shape[0]
        return SphereMixture(center,
                             torch.as_tensor(radius, **f32).reshape(n),
                             torch.as_tensor(sigma_a, **f32).reshape(n),
                             torch.as_tensor(sigma_s, **f32).reshape(n))

    @property
    def n(self) -> int:
        return self.center.shape[0]

    def to(self, device) -> "SphereMixture":
        return SphereMixture(*(getattr(self, f.name).to(device)
                               for f in dataclasses.fields(self)))

    def aabbs(self):
        """(center - radius, center + radius), each [N,3]: the box the
        marchers bound their steps by (the JAX package's ``_scene_t_end``
        and ``_medium_diag`` sphere branches)."""
        r = self.radius[:, None]
        return self.center - r, self.center + r

    def intersect(self, origin, direction):
        """(t_enter, t_exit, hit), each [..., N], of rays [..., 3] against
        every sphere (``Sphere::intersect``, smm.h:29-39): hit iff the
        closest approach lies inside the radius and t_exit >= 0; t is not
        clamped.  d2 = l.l - tca^2 cancels for distant rays, so a ray that
        grazes a rim can take the other hit decision under another
        rounding."""
        l = self.center - origin[..., None, :]                  # [...,N,3]
        tca = _dot3(l, direction[..., None, :], fused=True)
        d2 = _dot3(l, l, fused=False) - tca * tca
        r2 = self.radius * self.radius
        thc = torch.sqrt(torch.clamp(r2 - d2, min=0.0))
        return tca - thc, tca + thc, (d2 <= r2) & (tca + thc >= 0.0)

    def transmittance_up_to(self, origin, direction, tmax):
        """T = exp(-sum_i sigma_t_i * overlap([t0, t1] clip [0, tmax])) of
        rays [..., 3] up to tmax (a number or [...]); the closed form of
        ``transmittance_from_events`` (smm.h:79-103)."""
        t0, t1, hit = self.intersect(origin, direction)
        a = torch.clamp(t0, min=0.0)
        if isinstance(tmax, torch.Tensor) and tmax.dim():
            tmax = tmax[..., None]
        b = torch.minimum(t1, torch.as_tensor(tmax, dtype=t1.dtype,
                                              device=t1.device))
        seg = torch.clamp(b - a, min=0.0) * hit
        return torch.exp(-torch.sum((self.sigma_a + self.sigma_s) * seg,
                                    dim=-1))

    def sigma_at(self, active_mask):
        """(sigma_a, sigma_s) summed over the spheres of a boolean mask
        [..., N] (smm.h:66-76)."""
        return (torch.sum(self.sigma_a * active_mask, dim=-1),
                torch.sum(self.sigma_s * active_mask, dim=-1))
