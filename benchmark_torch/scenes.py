"""A configuration's scene, made on the card.

``random_gaussians`` draws the distribution of the upstream generator
(``scene/generators.random_gaussian_scene``, the reference's
``tests/make_random.py``) with one ``torch.Generator`` on the device, in
a few large calls: means uniform in the configuration's box, a random
rotation, per-axis diameters, density and albedo uniform in their
ranges.  The Gaussians come from the configuration's ``scene_seed``, as
the fixture is one file; the run's seed orders them, so every seed
renders the same set of Gaussians, in another order, and the work does
not change with the seed.  The rotation is that of a normalised Gaussian quaternion, a
uniform random rotation; the generator's QR of a Gaussian matrix gives a
uniform rotation up to the signs of its columns, which leave
R diag(s^2) R^T unchanged, so the covariances have one distribution.

The scene is written as GMM text with the generator's digits, the form in
which the fixture files reach the program, and the program parses it
(``parse_gmm``, which Morton-sorts above 512 Gaussians).  The reference
reads the same text (``reference.parse_scene``).
"""

from __future__ import annotations

import io

import numpy as np
import torch


def random_gaussians(config: dict, seed: int, device) -> str:
    """GMM scene text of ``config['n']`` Gaussians drawn from the
    configuration's ``scene_seed`` on ``device``, in an order drawn from
    ``seed``, with the configuration's lights."""
    n = config["n"]
    gen = torch.Generator(device=device)
    gen.manual_seed(config["scene_seed"])
    f64 = dict(dtype=torch.float64, device=device, generator=gen)

    def uniform(shape, lo, hi):
        lo = torch.as_tensor(lo, dtype=torch.float64, device=device)
        hi = torch.as_tensor(hi, dtype=torch.float64, device=device)
        return lo + (hi - lo) * torch.rand(shape, **f64)

    mean = uniform((n, 3), config["mean_lo"], config["mean_hi"])
    q = torch.randn((n, 4), **f64)
    w, x, y, z = (q / torch.linalg.vector_norm(q, dim=1, keepdim=True)).T
    rot = torch.stack([
        1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y),
        2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x),
        2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
        dim=1).view(n, 3, 3)
    sigma = uniform((n, 3), *config["diameter"]) / 2.0
    cov = rot @ torch.diag_embed(sigma * sigma) @ rot.transpose(1, 2)
    dens = uniform((n,), *config["density"])
    alb = uniform((n,), *config["albedo"])
    order = torch.Generator(device=device)
    order.manual_seed(seed % (1 << 64))
    perm = torch.randperm(n, generator=order, device=device)
    rows = torch.cat([mean, cov[:, 0, 0:3], cov[:, 1, 1:3], cov[:, 2, 2:3],
                      dens[:, None], alb[:, None]], dim=1)[perm].cpu().numpy()
    out = io.StringIO()
    for p in config["lights"]:
        out.write(f"l  {p[0]} {p[1]} {p[2]}    {p[3]} {p[4]} {p[5]}\n")
    np.savetxt(out, rows, fmt="g  %.6f %.6f %.6f    %.8f %.8f %.8f %.8f "
               "%.8f %.8f  %.4f %.4f")
    return out.getvalue()

