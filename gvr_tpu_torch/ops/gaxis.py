"""Reductions over the Gaussian axis, on one device.

Counterpart of ``gvr_tpu/ops/gaxis.py:43-67``.  Every reduction over the
Gaussian axis of the dense path (``ops/transmittance``, ``ops/solvers``,
``GaussianMixture.sigma_albedo``/``albedo_at``) goes through these
helpers, so a tensor-parallel path can complete them with collectives in
one place.  That path, the JAX package's named mesh axis, waits for its
port (ROADMAP Queue 1, parallelism): here the helpers are the plain torch
reductions and ``active()`` is None.
"""

from __future__ import annotations

from typing import Optional

import torch


def gsum(x: torch.Tensor, axis: int = -1) -> torch.Tensor:
    return torch.sum(x, dim=axis)


def gmax(x: torch.Tensor, axis: int = -1) -> torch.Tensor:
    return torch.amax(x, dim=axis)


def gmin(x: torch.Tensor, axis: int = -1) -> torch.Tensor:
    return torch.amin(x, dim=axis)


def gany(x: torch.Tensor, axis: int = -1) -> torch.Tensor:
    return torch.any(x, dim=axis)


def active() -> Optional[str]:
    """The live tensor-parallel axis name: always None on one device."""
    return None
