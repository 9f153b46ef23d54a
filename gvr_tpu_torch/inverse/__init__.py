"""Inverse rendering (``gvr_tpu/inverse``): the Adam fit (``fit``), per-pixel
Gaussian attribution (``attribution``) and the stochastic finite-difference
validation mode (``sfd``)."""

from gvr_tpu_torch.inverse.fit import FitState, fit_gaussians, fit_loss
from gvr_tpu_torch.inverse.sfd import sfd_gradient

__all__ = ["FitState", "fit_gaussians", "fit_loss", "sfd_gradient"]
