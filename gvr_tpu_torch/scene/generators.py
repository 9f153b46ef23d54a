"""Procedural random-scene generators (numpy only).

Copies of ``gvr_tpu/scene/generators.py``: ``random_gaussian_scene``, the
counterpart of the reference's ``tests/make_random.py`` (uniform means in
[-1,1]x[0,2]x[-1,1], random rotations via QR, small anisotropic diameters,
moderate densities and albedos), and ``random_sphere_scene`` (centres in
[-1.5,1.5]x[0,2.5]x[-1.5,1.5], one white point light above).  The same
arguments give the same text as the JAX package's generators.
"""

from __future__ import annotations

import numpy as np


def random_gaussian_scene(n: int, seed: int = 0,
                          diameter=(0.01, 0.035),
                          density=(0.2, 0.5),
                          albedo=(0.25, 0.95),
                          emission_prob: float = 0.0,
                          bias_low_y: bool = False,
                          lights=((0.0, 5.0, 0.1, 50.0, 0.0, 0.0),
                                  (-3.0, 3.0, 0.3, 0.0, 30.0, 0.0),
                                  (3.0, 3.0, -0.2, 0.0, 0.0, 30.0))) -> str:
    """Scene text with n random anisotropic Gaussians."""
    rng = np.random.default_rng(seed)
    lines = [f"l  {p[0]} {p[1]} {p[2]}    {p[3]} {p[4]} {p[5]}"
             for p in lights]
    for _ in range(n):
        mean = rng.uniform([-1.0, 0.0, -1.0], [1.0, 2.0, 1.0])
        if bias_low_y:
            mean[1] = 2.0 * (mean[1] / 2.0) ** 2.0   # power bias toward 0
        q, _ = np.linalg.qr(rng.normal(size=(3, 3)))
        diam = rng.uniform(*diameter, 3)
        sigma = diam / 2.0
        cov = q @ np.diag(sigma * sigma) @ q.T
        dens = rng.uniform(*density)
        alb = rng.uniform(*albedo)
        row = (f"g  {mean[0]:.6f} {mean[1]:.6f} {mean[2]:.6f}    "
               f"{cov[0, 0]:.8f} {cov[0, 1]:.8f} {cov[0, 2]:.8f} "
               f"{cov[1, 1]:.8f} {cov[1, 2]:.8f} {cov[2, 2]:.8f}  "
               f"{dens:.4f} {alb:.4f}")
        if emission_prob > 0 and rng.uniform() < emission_prob:
            e = rng.uniform(0.0, 1.0, 3)
            row += f"  {e[0]:.4f} {e[1]:.4f} {e[2]:.4f}"
        lines.append(row)
    return "\n".join(lines) + "\n"


def random_sphere_scene(n: int, seed: int = 0,
                        radius=(0.2, 0.8),
                        sigma_a=(0.0, 0.3),
                        sigma_s=(0.3, 1.0),
                        lights=((0.0, 4.0, 0.0, 35.0, 35.0, 35.0),)) -> str:
    """SMM scene text with n random homogeneous spheres."""
    rng = np.random.default_rng(seed)
    lines = [f"l {p[0]} {p[1]} {p[2]}   {p[3]} {p[4]} {p[5]}"
             for p in lights]
    for _ in range(n):
        c = rng.uniform([-1.5, 0.0, -1.5], [1.5, 2.5, 1.5])
        lines.append(
            f"s {c[0]:.4f} {c[1]:.4f} {c[2]:.4f}   "
            f"{rng.uniform(*radius):.4f}  {rng.uniform(*sigma_a):.4f} "
            f"{rng.uniform(*sigma_s):.4f}")
    return "\n".join(lines) + "\n"
