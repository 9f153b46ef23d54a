"""Reductions over the Gaussian axis, on one device or over a process group.

Counterpart of ``gvr_tpu/ops/gaxis.py``.  Every reduction over the
Gaussian axis of the dense path (``ops/transmittance``, ``ops/solvers``,
``GaussianMixture.sigma_albedo``/``albedo_at``) goes through the helpers
below.  Normally they are the plain torch reductions.  Inside
``gaussian_axis(group)``, which ``parallel/gauss_sharded`` sets around
the work of a rank that holds a slice of the mixture's rows, each local
reduction is completed with an all-reduce over ``group`` (SUM, MAX, MIN),
so the whole dense path (coefficients, bracketed Newton, NEE
transmittance, albedo, the implicit-function VJP) becomes a
tensor-parallel program.  Per-ray control flow sees identical
post-collective values on every rank of the group, so the ranks stay in
lockstep.

The context is a module global read when a helper is called, as JAX's is
read while tracing.  A backward pass that recomputes or differentiates
through these helpers (``torch.utils.checkpoint``, the conditional
solve's VJP) must therefore run inside the same context.

Gradients.  ``gsum``'s all-reduce has the identity backward on the
rank's local partial: everything after the sum is replicated over the
group, and each rank's partial receives the upstream cotangent once
(``torch.distributed.nn.functional.all_reduce`` would all-reduce the
cotangent again and scale every gradient by the group size).  The other
direction needs a collective: a replicated value (a ray's origin,
direction or distance, which depend on the parameters through earlier
bounces) that enters work over this rank's Gaussians gets part of its
cotangent from every rank's rows, so it passes through ``gshared``,
the identity whose backward sums the cotangent over the group
(``ops/transmittance._interval_pref`` and ``_as_t``,
``GaussianMixture.evaluate``).  Without it each rank would push only its
own rows' share back along the path, and the gradient would be wrong
without any error.  ``gmax``, ``gmin`` and ``gany`` return detached
values under the context, as they only bracket and gate.
"""

from __future__ import annotations

import contextlib
from typing import Optional

import torch
import torch.distributed as dist

_GROUP = None


@contextlib.contextmanager
def gaussian_axis(group):
    """Complete Gaussian-axis reductions with all-reduces over the
    process group ``group`` (see the module docstring)."""
    global _GROUP
    prev, _GROUP = _GROUP, group
    try:
        yield
    finally:
        _GROUP = prev


def all_reduce(x: torch.Tensor, op) -> torch.Tensor:
    """``x`` all-reduced in place with ``op`` over the active group;
    counts its calls in ``all_reduce.calls``."""
    dist.all_reduce(x, op=op, group=_GROUP)
    all_reduce.calls += 1
    return x


all_reduce.calls = 0


class _SumOverGroup(torch.autograd.Function):
    """Forward: the all-reduced sum of the ranks' partials; backward: the
    identity on this rank's partial."""

    @staticmethod
    def forward(ctx, s):
        return all_reduce(s.clone(), dist.ReduceOp.SUM)

    @staticmethod
    def backward(ctx, g):
        return g


class _SharedOverGroup(torch.autograd.Function):
    """Forward: the identity; backward: the cotangent summed over the
    group."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g.contiguous().clone(), dist.ReduceOp.SUM)


def gshared(x):
    """``x``, a value every rank of the group holds alike, where it enters
    work over this rank's Gaussians (see the module docstring); ``x``
    itself outside the context or where it needs no gradient."""
    if _GROUP is None or not isinstance(x, torch.Tensor) \
            or not x.requires_grad:
        return x
    return _SharedOverGroup.apply(x)


def gsum(x: torch.Tensor, axis: int = -1) -> torch.Tensor:
    s = torch.sum(x, dim=axis)
    return _SumOverGroup.apply(s) if _GROUP is not None else s


def gmax(x: torch.Tensor, axis: int = -1) -> torch.Tensor:
    s = torch.amax(x, dim=axis)
    if _GROUP is None:
        return s
    return all_reduce(s.detach().clone(), dist.ReduceOp.MAX)


def gmin(x: torch.Tensor, axis: int = -1) -> torch.Tensor:
    s = torch.amin(x, dim=axis)
    if _GROUP is None:
        return s
    return all_reduce(s.detach().clone(), dist.ReduceOp.MIN)


def gany(x: torch.Tensor, axis: int = -1) -> torch.Tensor:
    a = torch.any(x, dim=axis)
    if _GROUP is None:
        return a
    return all_reduce(a.to(torch.int32), dist.ReduceOp.MAX) > 0


def active() -> Optional[object]:
    """The live tensor-parallel process group, or None."""
    return _GROUP
