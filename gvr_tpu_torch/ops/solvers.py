"""The bracketed Newton + Illinois steps of the free-flight solve.

``illinois_update`` is the counterpart of ``gvr_tpu/ops/solvers.py:63
illinois_update``: the one copy in this package, used by the plain bounce
(``kernels/pathtrace``) and the grid solve, and mirrored line for line by
``illinois_update`` in ``csrc/bounce.cuh``.  ``illinois_update_inset`` is
the step the JAX package's big-N kernel writes out for itself
(``gvr_tpu/kernels/pathtrace_big.py:174-198``), mirrored by
``csrc/big.cuh``.  The XLA engine and the ablation solvers of that module
wait for their port (ROADMAP Queue 1, the rest of ops/solvers).
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


# The big-N kernel's regula-falsi clip: an inset of this fraction of the
# bracket at each end (the JAX package's round-2 FALSI_MARGIN, which its
# canonical step has since set to 0).
FALSI_INSET = 0.05


def illinois_update_inset(lo, hi, flo, fhi, t, f, sig):
    """``illinois_update`` as the big-N kernel K4 has it: the falsi point
    is clipped to [lo + 0.05 (hi - lo), hi - 0.05 (hi - lo)] and a Newton
    point is taken without a finiteness test.  This is a known difference
    between the JAX package's engines, kept so the port matches each."""
    neg = f < 0.0
    flo = torch.where(neg, f, flo * 0.5)
    fhi = torch.where(neg, fhi * 0.5, f)
    lo = torch.where(neg, t, lo)
    hi = torch.where(neg, hi, t)
    t_n = t - f / torch.clamp(sig, min=1e-30)
    good = (t_n > lo) & (t_n < hi)
    denom = fhi - flo
    t_f = hi - fhi * (hi - lo) / torch.where(denom.abs() > 1e-30, denom,
                                             1e-30)
    t_f = torch.minimum(torch.maximum(t_f, lo + FALSI_INSET * (hi - lo)),
                        hi - FALSI_INSET * (hi - lo))
    return lo, hi, flo, fhi, torch.where(good, t_n, t_f)
