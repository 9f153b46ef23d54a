"""Per-(ray, Gaussian) quadratic coefficients of the Mahalanobis distance.

Counterpart of ``gvr_tpu/ops/quadratics.py:41-138`` (reference
``gaussian.h:126-231``).  Along a ray o + t d the squared Mahalanobis
distance to Gaussian n is A t^2 + B t + C with

    A = d^T S^-1 d,   B = 2 (o - m)^T S^-1 d,   C = (o - m)^T S^-1 (o - m).

Each bilinear form against the symmetric S^-1 is the dot product of six
products of u and v (``sym6``) with the packed entries of S^-1
(``GaussianMixture.icpack``).  The JAX package writes these as matmuls at
``Precision.HIGHEST``, because A C - B^2 cancels and reduced-precision
passes make spurious hits.  Here every product is an explicit elementwise
multiply-add in float32, so no global flag (TF32 matmuls) can change it.
The sums are fused multiply-adds (``torch.addcmul``) in the order XLA's
CPU dot and fusions take, so on the CPU the coefficients are the JAX
package's to the bit or nearly.
"""

from __future__ import annotations

import torch

from gvr_tpu_torch.scene.gaussians import R_CUT, GaussianMixture


def _mm(feats: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """[..., F] x [N, F] -> [..., N] in float32: the JAX package's ``_mm``
    as a chain of fused multiply-adds over f in order."""
    out = feats[..., 0:1] * table[:, 0]
    for f in range(1, feats.shape[-1]):
        out = torch.addcmul(out, feats[..., f:f + 1], table[:, f])
    return out


def sym6_terms(u, v) -> list:
    """The six features of ``sym6`` as a list, from u and v given as
    sequences of their three components (tensors of one shape), so a
    caller with [rays, N] components builds no [rays, N, 6] tensor."""
    def cross(i, j):
        return torch.addcmul(u[j] * v[i], u[i], v[j])

    return [u[0] * v[0], u[1] * v[1], u[2] * v[2], cross(0, 1), cross(0, 2),
            cross(1, 2)]


def sym6(u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Symmetric bilinear features [..., 6] such that
    u^T S v = sym6(u, v) . (S00, S11, S22, S01, S02, S12) for symmetric S."""
    return torch.stack(sym6_terms(u.unbind(-1), v.unbind(-1)), dim=-1)


def ray_quadratics_ab(gmm: GaussianMixture, origin, direction):
    """(A, B) for rays [..., 3] against all N Gaussians, each [..., N].
    The hot paths need no C: the interval and the exponent come from the
    closest-approach form (``ops/transmittance``)."""
    ic = gmm.icpack()
    q = gmm.qvec()
    a = _mm(sym6(direction, direction), ic)
    d_q = _mm(direction, q)
    b = 2.0 * (_mm(sym6(origin, direction), ic) - d_q)
    return a, b


def ray_quadratics(gmm: GaussianMixture, origin, direction):
    """(A, B, C) for rays [..., 3] against all N Gaussians, each [..., N];
    C is the full Mahalanobis constant (no -R_CUT^2)."""
    a, b = ray_quadratics_ab(gmm, origin, direction)
    o_q = _mm(origin, gmm.qvec())
    c = _mm(sym6(origin, origin), gmm.icpack()) - 2.0 * o_q + gmm.c0()
    return a, b, c


def intersect_from_quadratics(a, b, c):
    """(t0, t1, hit) of the R_CUT-sigma ellipsoid from (A, B, C-full):
    t0 <= t1, hit iff the ray crosses it with t1 >= 0 (gaussian.h:141-163).
    t0 is not clamped to 0."""
    cc = c - R_CUT * R_CUT
    disc = b * b - 4.0 * a * cc
    hit = (disc >= 0.0) & (a > 0.0)
    sq = torch.sqrt(torch.where(disc > 0.0, disc, 1.0))
    sq = torch.where(disc > 0.0, sq, 0.0)
    inv2a = 0.5 / torch.clamp(a, min=1e-30)
    t0 = (-b - sq) * inv2a
    t1 = (-b + sq) * inv2a
    return t0, t1, hit & (t1 >= 0.0)


def intersect_gaussians(gmm: GaussianMixture, origin, direction):
    """Intervals of every Gaussian along rays: (t0, t1, hit), each [..., N]."""
    return intersect_from_quadratics(*ray_quadratics(gmm, origin, direction))


def intersect_gaussians_whitening(gmm: GaussianMixture, origin, direction):
    """The whitening variant (gaussian.h:167-205): the ray in the frame
    W = diag(1/sqrt(eigval)) R^T / R_CUT against the unit sphere.  The same
    intervals as the direct quadratic, kept to cross-check it."""
    ev = torch.clamp(gmm.eigvals, min=1e-12)
    w = (1.0 / torch.sqrt(ev))[:, :, None] * gmm.eigvecs.transpose(1, 2) \
        / R_CUT                                         # [N,3,3]
    o_local = origin[..., None, :] - gmm.mean           # [...,N,3]
    ow = [o_local[..., 0] * w[:, i, 0] + o_local[..., 1] * w[:, i, 1]
          + o_local[..., 2] * w[:, i, 2] for i in range(3)]
    dw = [direction[..., None, 0] * w[:, i, 0]
          + direction[..., None, 1] * w[:, i, 1]
          + direction[..., None, 2] * w[:, i, 2] for i in range(3)]
    a = dw[0] * dw[0] + dw[1] * dw[1] + dw[2] * dw[2]
    b = 2.0 * (ow[0] * dw[0] + ow[1] * dw[1] + ow[2] * dw[2])
    c = ow[0] * ow[0] + ow[1] * ow[1] + ow[2] * ow[2] - 1.0
    disc = b * b - 4.0 * a * c
    sq = torch.sqrt(torch.where(disc > 0.0, disc, 0.0))
    inv2a = 0.5 / torch.clamp(a, min=1e-30)
    t0 = (-b - sq) * inv2a
    t1 = (-b + sq) * inv2a
    return t0, t1, (disc >= 0.0) & (t1 >= 0.0)
