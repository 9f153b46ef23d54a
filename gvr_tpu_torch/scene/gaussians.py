"""Gaussian mixture medium as structure-of-arrays tensors.

Counterpart of ``gvr_tpu/scene/gaussians.py`` (reference ``gaussian.h``,
``gmm.h``).  Anisotropic 3D Gaussian density
g(x) = norm * exp(-0.5 (x-mu)^T S^-1 (x-mu)), norm = (2 pi)^-1.5 det(S)^-1/2;
extinction mu_t(x) = density * g(x); support truncated at R_CUT sigma.

``aabbs`` feeds the grid build (``accel/grid``); ``morton_sorted`` orders
the Gaussians along a Z-order curve of their means, which the big-N dense
kernels (``kernels/pathtrace_big``) rely on for chunk culling;
``evaluate``, ``mu_t``, ``sigma_albedo`` and ``albedo_at`` give the
mixture at points, for the ray marchers.  The 11-parameter codec waits
for a later slice.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from gvr_tpu_torch.ops.gaxis import gsum

# Support truncation radius in units of standard deviation (gaussian.h:36).
R_CUT = 3.0


@dataclasses.dataclass
class GaussianMixture:
    """SoA Gaussian mixture; every tensor is float32 with leading dim N.

    mean [N,3], cov [N,3,3], density [N], albedo [N], emission [N,3]
    (parsed, never shaded, as in the reference), inv_cov [N,3,3],
    norm [N], eigvals [N,3] ascending, eigvecs [N,3,3] (columns, det +1).
    """

    mean: torch.Tensor
    cov: torch.Tensor
    density: torch.Tensor
    albedo: torch.Tensor
    emission: torch.Tensor
    inv_cov: torch.Tensor
    norm: torch.Tensor
    eigvals: torch.Tensor
    eigvecs: torch.Tensor

    @staticmethod
    def from_covariances(mean, cov, density, albedo, emission=None,
                         device="cpu") -> "GaussianMixture":
        """Build from means [N,3] and full covariances [N,3,3]: one batched
        eigh, eigenvectors flipped to a proper rotation, inv_cov rebuilt as
        R diag(1/ev) R^T (gaussian.h:52-72, gvr_tpu's from_covariances)."""
        f32 = dict(dtype=torch.float32, device=device)
        mean = torch.as_tensor(mean, **f32).reshape(-1, 3)
        cov = torch.as_tensor(cov, **f32).reshape(-1, 3, 3)
        n = mean.shape[0]
        density = torch.as_tensor(density, **f32).reshape(n)
        albedo = torch.as_tensor(albedo, **f32).reshape(n)
        if emission is None:
            emission = torch.zeros((n, 3), **f32)
        emission = torch.as_tensor(emission, **f32).reshape(n, 3)

        eigvals, eigvecs = torch.linalg.eigh(cov)
        flip = torch.where(torch.linalg.det(eigvecs) < 0.0, -1.0, 1.0)
        eigvecs = eigvecs.clone()
        eigvecs[:, :, 0] *= flip[:, None]
        ev = torch.clamp(eigvals, min=1e-12)
        inv_cov = torch.einsum("nij,nj,nkj->nik", eigvecs, 1.0 / ev, eigvecs)
        det_cov = torch.prod(ev, dim=-1)
        norm = (2.0 * math.pi) ** (-1.5) * det_cov ** (-0.5)
        return GaussianMixture(mean, cov, density, albedo, emission,
                               inv_cov, norm, eigvals, eigvecs)

    @property
    def n(self) -> int:
        return self.mean.shape[0]

    def to(self, device) -> "GaussianMixture":
        return GaussianMixture(*(getattr(self, f.name).to(device)
                                 for f in dataclasses.fields(self)))

    def icpack(self) -> torch.Tensor:
        """[N,6] packed inverse covariance (ic00, ic11, ic22, ic01, ic02,
        ic12)."""
        ic = self.inv_cov
        return torch.stack([ic[:, 0, 0], ic[:, 1, 1], ic[:, 2, 2],
                            ic[:, 0, 1], ic[:, 0, 2], ic[:, 1, 2]], dim=-1)

    def qvec(self) -> torch.Tensor:
        """[N,3] inv_cov @ mean, summed in index order."""
        ic, m = self.inv_cov, self.mean
        return (ic[:, :, 0] * m[:, 0:1] + ic[:, :, 1] * m[:, 1:2]
                + ic[:, :, 2] * m[:, 2:3])

    def c0(self) -> torch.Tensor:
        """[N] mean^T inv_cov mean."""
        q, m = self.qvec(), self.mean
        return q[:, 0] * m[:, 0] + q[:, 1] * m[:, 1] + q[:, 2] * m[:, 2]

    def evaluate(self, x: torch.Tensor) -> torch.Tensor:
        """Densities of every Gaussian at points x [..., 3] -> [..., N]
        (``Gaussian::evaluate``, gaussian.h:111-115): norm * exp(-d^T S^-1
        d / 2), the form summed by explicit multiply-adds in float32."""
        d = [x[..., None, i] - self.mean[:, i] for i in range(3)]
        ic = self.inv_cov
        q = None
        for i in range(3):
            w = d[0] * ic[:, 0, i] + d[1] * ic[:, 1, i] + d[2] * ic[:, 2, i]
            q = w * d[i] if q is None else q + w * d[i]
        return self.norm * torch.exp(-0.5 * q)

    def mu_t(self, x: torch.Tensor) -> torch.Tensor:
        """Extinction of every Gaussian at x: density * evaluate
        (gaussian.h:117)."""
        return self.density * self.evaluate(x)

    def sigma_albedo(self, x: torch.Tensor, active_mask: torch.Tensor):
        """(sigma_a, sigma_s) of the mixture at x over the Gaussians of a
        boolean mask [..., N] (gmm.h:98-126): with mu the summed
        extinction and a its extinction-weighted albedo, sigma_s = a mu
        and sigma_a = (1 - a) mu."""
        mt = self.mu_t(x) * active_mask
        s = gsum(mt)
        sa = gsum(mt * self.albedo)
        amix = torch.where(s > 1e-25, sa / torch.where(s > 1e-25, s, 1.0),
                           0.0)
        return (1.0 - amix) * s, amix * s

    def albedo_at(self, x: torch.Tensor, active_mask: torch.Tensor):
        """The mixture's single-scattering albedo at x over the Gaussians
        of a mask (gmm.h:128-143), clamped to [0, 1]."""
        mt = self.mu_t(x) * active_mask
        s = gsum(mt)
        sa = gsum(mt * self.albedo)
        amix = torch.where(s > 1e-25, sa / torch.where(s > 1e-25, s, 1.0),
                           0.0)
        return torch.clamp(amix, 0.0, 1.0)

    def morton_sorted(self) -> "GaussianMixture":
        """The Gaussians reordered along the Z-order curve of their means
        (``morton_order``), as ``gvr_tpu``'s ``morton_sorted``: the mixture
        is order-invariant, but then each 256-row chunk of the packed table
        is spatially compact, so a coherent ray block touches few chunks."""
        order = torch.from_numpy(morton_order(
            self.mean.detach().cpu().numpy())).to(self.mean.device)
        return GaussianMixture(*(getattr(self, f.name)[order]
                                 for f in dataclasses.fields(self)))

    def aabbs(self):
        """World AABBs at R_CUT sigma: (bmin [N,3], bmax [N,3]).

        The half-extent h_i = sum_j |R_ij| * R_CUT sqrt(ev_j) is summed as
        XLA sums it on the CPU, a fused multiply-add chain over j; each
        step is emulated in float64 (a product of two float32 is exact
        there) and rounded to float32, so the same mixture gives the same
        boxes, and so the same grid, in both packages."""
        ext = (R_CUT * torch.sqrt(torch.clamp(self.eigvals, min=0.0)))
        prod = self.eigvecs.abs().double() * ext.double()[:, None, :]
        h = prod[..., 0].float()
        for j in (1, 2):
            h = (prod[..., j] + h.double()).float()
        return self.mean - h, self.mean + h


def morton_order(points: np.ndarray) -> np.ndarray:
    """Stable permutation sorting 3D points along a 30-bit Z-order curve
    (10 bits an axis over the points' bounding box): a copy of
    ``gvr_tpu/scene/gaussians.py:morton_order``, so both packages order a
    scene alike."""
    p = np.asarray(points, np.float64)
    lo = p.min(axis=0)
    span = np.maximum(p.max(axis=0) - lo, 1e-12)
    q = np.clip((p - lo) / span * 1023.0, 0, 1023).astype(np.uint64)

    def spread(x):
        x = (x | (x << 16)) & np.uint64(0x030000FF)
        x = (x | (x << 8)) & np.uint64(0x0300F00F)
        x = (x | (x << 4)) & np.uint64(0x030C30C3)
        x = (x | (x << 2)) & np.uint64(0x09249249)
        return x

    code = spread(q[:, 0]) | (spread(q[:, 1]) << np.uint64(1)) \
        | (spread(q[:, 2]) << np.uint64(2))
    return np.argsort(code, kind="stable")
