"""Gaussian mixture medium as structure-of-arrays tensors.

Counterpart of ``gvr_tpu/scene/gaussians.py`` (reference ``gaussian.h``,
``gmm.h``).  Anisotropic 3D Gaussian density
g(x) = norm * exp(-0.5 (x-mu)^T S^-1 (x-mu)), norm = (2 pi)^-1.5 det(S)^-1/2;
extinction mu_t(x) = density * g(x); support truncated at R_CUT sigma.

``aabbs`` feeds the grid build (``accel/grid``); ``morton_sorted`` orders
the Gaussians along a Z-order curve of their means, which the big-N dense
kernels (``kernels/pathtrace_big``) rely on for chunk culling;
``evaluate``, ``mu_t``, ``sigma_albedo`` and ``albedo_at`` give the
mixture at points, for the ray marchers and the differentiable estimator.
``pack_parameters`` and ``from_parameters`` are the 11-parameter codec of
the inverse renderer (gmm.h:583-674): mean, Rodrigues axis-angle,
log-scales, log-density and logit-albedo, decoded without an eigh so
that the decode is differentiable.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from gvr_tpu_torch.ops.gaxis import gshared, gsum

# Support truncation radius in units of standard deviation (gaussian.h:36).
R_CUT = 3.0

# The most matrices of one batched eigh (``from_covariances``): cuSOLVER's
# batched 3x3 eigh took 10,000 and refused 40,000 on the H100.
EIGH_BATCH = 8192

# Optimizable parameters per Gaussian in the codec (gmm.h:583-628): mean
# (3), Rodrigues axis-angle (3), log-scales (3), log-density, logit-albedo.
PARAMS_PER_GAUSSIAN = 11


@dataclasses.dataclass
class GaussianMixture:
    """SoA Gaussian mixture; every tensor is float32 with leading dim N.

    mean [N,3], cov [N,3,3], density [N], albedo [N], emission [N,3]
    (parsed, never shaded, as in the reference), inv_cov [N,3,3],
    norm [N], eigvals [N,3] and eigvecs [N,3,3] (columns, det +1) with
    cov = eigvecs diag(eigvals) eigvecs^T.  ``from_covariances`` gives the
    eigenvalues ascending; ``from_rotation_scale`` (and so
    ``from_parameters``) gives s^2 in the codec's axis order, unsorted,
    and R.
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
        """Build from means [N,3] and full covariances [N,3,3]: batched
        eighs of at most EIGH_BATCH matrices (cuSOLVER's batched eigh
        refuses a batch of 40,000 3x3 matrices), eigenvectors flipped to a
        proper rotation, inv_cov rebuilt as R diag(1/ev) R^T
        (gaussian.h:52-72, gvr_tpu's from_covariances)."""
        f32 = dict(dtype=torch.float32, device=device)
        mean = torch.as_tensor(mean, **f32).reshape(-1, 3)
        cov = torch.as_tensor(cov, **f32).reshape(-1, 3, 3)
        n = mean.shape[0]
        density = torch.as_tensor(density, **f32).reshape(n)
        albedo = torch.as_tensor(albedo, **f32).reshape(n)
        if emission is None:
            emission = torch.zeros((n, 3), **f32)
        emission = torch.as_tensor(emission, **f32).reshape(n, 3)

        eigvals, eigvecs = (torch.cat(x) for x in zip(*(
            torch.linalg.eigh(c) for c in torch.split(cov, EIGH_BATCH))))
        flip = torch.where(torch.linalg.det(eigvecs) < 0.0, -1.0, 1.0)
        eigvecs = eigvecs.clone()
        eigvecs[:, :, 0] *= flip[:, None]
        ev = torch.clamp(eigvals, min=1e-12)
        inv_cov = torch.einsum("nij,nj,nkj->nik", eigvecs, 1.0 / ev, eigvecs)
        det_cov = torch.prod(ev, dim=-1)
        norm = (2.0 * math.pi) ** (-1.5) * det_cov ** (-0.5)
        return GaussianMixture(mean, cov, density, albedo, emission,
                               inv_cov, norm, eigvals, eigvecs)

    @staticmethod
    def from_rotation_scale(mean, rotation, scale_diag, density, albedo,
                            emission=None) -> "GaussianMixture":
        """Build from rotations [N,3,3] and scale diagonals [N,3] (the R S
        S^T R^T constructor, gaussian.h:95-109) on the device of ``mean``,
        without an eigh, so gradients flow through it: cov and inv_cov are
        R diag(s^2) R^T and R diag(1/s^2) R^T, summed elementwise (no
        matmul, so no TF32), and norm is exp(-sum(log s^2) / 2) in log
        space, which cannot underflow where the scales collapse."""
        f32 = dict(dtype=torch.float32, device=torch.as_tensor(mean).device)
        mean = torch.as_tensor(mean, **f32).reshape(-1, 3)
        rotation = torch.as_tensor(rotation, **f32).reshape(-1, 3, 3)
        scale_diag = torch.as_tensor(scale_diag, **f32).reshape(-1, 3)
        n = mean.shape[0]
        density = torch.as_tensor(density, **f32).reshape(n)
        albedo = torch.as_tensor(albedo, **f32).reshape(n)
        if emission is None:
            emission = torch.zeros((n, 3), **f32)
        emission = torch.as_tensor(emission, **f32).reshape(n, 3)
        s2 = torch.clamp(scale_diag * scale_diag, min=1e-24)
        cov = _rotate_diag(rotation, s2)
        inv_cov = _rotate_diag(rotation, 1.0 / s2)
        norm = (2.0 * math.pi) ** (-1.5) * torch.exp(
            -0.5 * torch.sum(torch.log(s2), dim=-1))
        return GaussianMixture(mean, cov, density, albedo, emission,
                               inv_cov, norm, s2, rotation)

    @staticmethod
    def from_parameters(params: torch.Tensor,
                        emission=None) -> "GaussianMixture":
        """Decode a flat [N*11] parameter vector (gmm.h:634-674):
        differentiable, on the vector's device."""
        p = params.reshape(-1, PARAMS_PER_GAUSSIAN)
        return GaussianMixture.from_rotation_scale(
            p[:, 0:3], rodrigues_to_rotation(p[:, 3:6]),
            torch.exp(p[:, 6:9]), torch.exp(p[:, 9]),
            torch.sigmoid(p[:, 10]), emission)

    def pack_parameters(self) -> torch.Tensor:
        """The flat [N*11] parameter vector (gmm.h:583-628): mean, the
        Rodrigues vector of eigvecs, log-scales, log-density and
        logit-albedo, so an unconstrained optimizer keeps the scales and
        density positive and the albedo in [0, 1]."""
        sdiag = torch.sqrt(torch.clamp(self.eigvals, min=1e-24))
        log_d = torch.log(torch.clamp(self.density, min=1e-12))
        logit_a = inv_sigmoid(torch.clamp(self.albedo, 0.0, 1.0))
        return torch.cat([self.mean, rotation_to_rodrigues(self.eigvecs),
                          torch.log(torch.clamp(sdiag, min=1e-12)),
                          log_d[:, None], logit_a[:, None]],
                         dim=-1).reshape(-1)

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
        x = gshared(x)
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


def _rotate_diag(r: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """R diag(s) R^T for R [N,3,3] and s [N,3] by elementwise products
    summed over j in order: einsum('nij,nj,nkj->nik')."""
    rs = r * s[:, None, :]
    out = rs[:, :, None, 0] * r[:, None, :, 0]
    for j in (1, 2):
        out = out + rs[:, :, None, j] * r[:, None, :, j]
    return out


def rotation_to_rodrigues(r: torch.Tensor) -> torch.Tensor:
    """Rotations [N,3,3] -> axis * angle vectors [N,3], through a
    quaternion by Shepperd's method: the row of the largest of the four
    squared components divides by a quantity >= 1/2, so every angle is
    well conditioned, near pi too.  The factor angle / sin(angle/2) takes
    its limit 2 below sin 1e-6; a non-finite result maps to 0, as the
    reference's guard does (gmm.h:597-607)."""
    r00, r11, r22 = r[:, 0, 0], r[:, 1, 1], r[:, 2, 2]
    qw2 = 1.0 + r00 + r11 + r22
    qx2 = 1.0 + r00 - r11 - r22
    qy2 = 1.0 - r00 + r11 - r22
    qz2 = 1.0 - r00 - r11 + r22
    a = r[:, 2, 1] - r[:, 1, 2]
    b = r[:, 0, 2] - r[:, 2, 0]
    c = r[:, 1, 0] - r[:, 0, 1]
    d = r[:, 0, 1] + r[:, 1, 0]
    e = r[:, 0, 2] + r[:, 2, 0]
    f = r[:, 1, 2] + r[:, 2, 1]
    # row i is the quaternion (w, x, y, z) scaled by 4 q_i
    cand = torch.stack([torch.stack([qw2, a, b, c], dim=-1),
                        torch.stack([a, qx2, d, e], dim=-1),
                        torch.stack([b, d, qy2, f], dim=-1),
                        torch.stack([c, e, f, qz2], dim=-1)], dim=1)
    idx = torch.argmax(torch.stack([qw2, qx2, qy2, qz2], dim=-1), dim=-1)
    q = torch.gather(cand, 1, idx[:, None, None].expand(-1, 1, 4))[:, 0]
    q = q / torch.clamp(torch.linalg.vector_norm(q, dim=-1, keepdim=True),
                        min=1e-12)
    q = q * torch.where(q[:, :1] < 0.0, -1.0, 1.0)
    s = torch.linalg.vector_norm(q[:, 1:], dim=-1)
    angle = 2.0 * torch.atan2(s, q[:, 0])
    factor = torch.where(s < 1e-6, 2.0, angle / torch.clamp(s, min=1e-12))
    rod = q[:, 1:] * factor[:, None]
    return torch.where(torch.isfinite(rod), rod, 0.0)


def rodrigues_to_rotation(rod: torch.Tensor) -> torch.Tensor:
    """Axis * angle vectors [N,3] -> rotations [N,3,3] (gmm.h:644-651) in
    the sinc form on the unnormalised skew matrix K,
    R = I + sin(t)/t K + (1 - cos t)/t^2 K^2, with Taylor branches for
    both ratios below t^2 = 1e-8: smooth, with finite gradients, at rod =
    0, where axis-aligned Gaussians pack.  K^2 is summed elementwise (no
    matmul, so no TF32)."""
    t2 = torch.sum(rod * rod, dim=-1)
    t = torch.sqrt(torch.clamp(t2, min=1e-24))
    small = t2 < 1e-8
    sin_ratio = torch.where(small, 1.0 - t2 / 6.0, torch.sin(t) / t)
    cos_ratio = torch.where(small, 0.5 - t2 / 24.0,
                            (1.0 - torch.cos(t)) / torch.clamp(t2, min=1e-24))
    x, y, z = rod[:, 0], rod[:, 1], rod[:, 2]
    zero = torch.zeros_like(x)
    k = torch.stack([torch.stack([zero, -z, y], dim=-1),
                     torch.stack([z, zero, -x], dim=-1),
                     torch.stack([-y, x, zero], dim=-1)], dim=-2)
    k2 = k[:, :, None, 0] * k[:, None, 0, :]
    for j in (1, 2):
        k2 = k2 + k[:, :, None, j] * k[:, None, j, :]
    eye = torch.eye(3, dtype=rod.dtype, device=rod.device)[None]
    return (eye + sin_ratio[:, None, None] * k
            + cos_ratio[:, None, None] * k2)


def inv_sigmoid(y: torch.Tensor) -> torch.Tensor:
    """The logit with its argument clipped to [1e-7, 1 - 1e-7]
    (gmm.h:28-32)."""
    yy = torch.clamp(y, 1e-7, 1.0 - 1e-7)
    return torch.log(yy / (1.0 - yy))


def default_param_eps(n_gaussians: int) -> np.ndarray:
    """Per-parameter finite-difference steps of the SFD validation mode
    (gmm.h:677-706): mean 0.02, rotation 0.1, log-scale 0.05,
    log-density 0.25, logit-albedo 0.5."""
    per = np.array([0.02, 0.02, 0.02, 0.10, 0.10, 0.10, 0.05, 0.05, 0.05,
                    0.25, 0.5], np.float32)
    return np.tile(per, n_gaussians)


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
