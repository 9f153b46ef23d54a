"""The bracketed Newton + Illinois step of the free-flight solve.

Counterpart of ``gvr_tpu/ops/solvers.py:63 illinois_update``: the one copy
in this package, used by the plain bounce (``kernels/pathtrace``) and
mirrored line for line by ``illinois_update`` in ``csrc/bounce.cuh``.  The
XLA engine and the ablation solvers of that module wait for their port
(ROADMAP Queue 1, the rest of ops/solvers).
"""

from __future__ import annotations

import torch


def illinois_update(lo, hi, flo, fhi, t, f, sig):
    """One safeguarded Newton + Illinois step on tau(t) - target.

    f = tau(t) - target and sig = dtau/dt at t; returns the updated
    (lo, hi, flo, fhi, t_next).  A Newton step that leaves the bracket
    falls back to the regula-falsi secant with the stale side's f halved."""
    neg = f < 0.0
    flo = torch.where(neg, f, flo * 0.5)
    fhi = torch.where(neg, fhi * 0.5, f)
    lo = torch.where(neg, t, lo)
    hi = torch.where(neg, hi, t)
    t_n = t - f / torch.clamp(sig, min=1e-30)
    good = (t_n > lo) & (t_n < hi) & torch.isfinite(t_n)
    denom = fhi - flo
    t_f = hi - fhi * (hi - lo) / torch.where(denom.abs() > 1e-30, denom,
                                             1e-30)
    t_f = torch.minimum(torch.maximum(t_f, lo), hi)
    return lo, hi, flo, fhi, torch.where(good, t_n, t_f)
