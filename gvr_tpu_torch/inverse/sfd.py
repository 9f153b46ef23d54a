"""Stochastic finite-difference gradients, the validation mode.

Counterpart of ``gvr_tpu/inverse/sfd.py`` (reference
inverse_integrator.h:118-193):

* ``sfd_gradient``: Rademacher signs s, forward differences of the loss
  at params + s eps, grad ~= mean_s (L(p + s eps) - L(p)) s / eps;
* ``sfd_gradient_localized``: the reference's estimator, per-pixel L1
  losses (:20-29) and, for each Gaussian, the loss change summed over the
  union of its base and perturbed pixel footprints (:165-188), the
  footprints from ``inverse/attribution`` (``footprint_fn``).

The fit's optimizer is autodiff (``inverse/fit``); these cross-check the
signs and magnitudes of its gradients.  The callables are plain functions
of a parameter tensor (the JAX package jits them); the perturbations are
numpy float32 and made by ``rng``, as in the JAX package, so one
generator gives both packages the same signs.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from gvr_tpu_torch.inverse.attribution import (pixel_gaussians,
                                               pixel_gaussians_paths)
from gvr_tpu_torch.scene.gaussians import (PARAMS_PER_GAUSSIAN,
                                           GaussianMixture,
                                           default_param_eps)


def _host(params):
    """(params as float32 numpy, the device to evaluate on)."""
    if isinstance(params, torch.Tensor):
        return params.detach().cpu().numpy(), params.device
    return np.asarray(params, np.float32), torch.device("cpu")


def sfd_gradient(loss_of_params: Callable, params, num_samples: int = 4,
                 rng=None, eps: np.ndarray = None) -> np.ndarray:
    """d loss / d params [P] float32 by stochastic forward differences;
    ``loss_of_params`` takes a parameter tensor on the device of
    ``params`` (a tensor; numpy evaluates on the CPU)."""
    rng = rng or np.random.default_rng(0)
    p, dev = _host(params)
    if eps is None:
        eps = default_param_eps(p.size // PARAMS_PER_GAUSSIAN)

    def loss(x):
        with torch.no_grad():
            return float(loss_of_params(torch.from_numpy(x).to(dev)))

    base = loss(p)
    grad = np.zeros_like(p, np.float64)
    for _ in range(num_samples):
        s = rng.choice(np.array([-1.0, 1.0], np.float32), p.shape)
        grad += (loss(p + s * eps) - base) * s / eps
    return (grad / num_samples).astype(np.float32)


def footprint_fn(scene_template, camera, cfg, k: int = 16,
                 paths: bool = False, spp: int | None = None) -> Callable:
    """``footprint_of_params``: params -> [H*W, k] int32 Gaussian indices
    per pixel (-1 padded), by ``pixel_gaussians`` (primary rays) or, with
    ``paths``, ``pixel_gaussians_paths`` (the multi-bounce recording over
    ``spp`` paths), on the device of ``scene_template``.  A footprint
    that would be truncated (a pixel reaching more than k Gaussians)
    raises: localized SFD would drop those Gaussians' loss changes."""
    dev = scene_template.medium.mean.device

    def fp(params):
        p = torch.as_tensor(np.asarray(params, np.float32), device=dev)
        sc = scene_template.with_medium(GaussianMixture.from_parameters(p))
        if paths:
            idx, cnt = pixel_gaussians_paths(sc, camera, cfg, k, spp)
        else:
            idx, cnt = pixel_gaussians(sc, camera, cfg, k)
        over = int(np.max(cnt)) if cnt.size else 0
        if over > min(k, sc.medium.n):
            raise ValueError(
                f"footprint_fn: a pixel's footprint reaches {over} "
                f"gaussians (> k={k}); localized SFD would silently drop "
                f"their contributions — call footprint_fn with k>={over}")
        return idx

    return fp


def sfd_gradient_localized(image_of_params: Callable,
                           footprint_of_params: Callable, params,
                           target: np.ndarray, num_samples: int = 4,
                           rng=None, eps: np.ndarray = None) -> np.ndarray:
    """The union-footprint SFD gradient [P] float32 (inverse_integrator.h
    :118-188).  For each sample s: render params + s eps, take per-pixel
    L1 losses of the base and perturbed images (:20-29), sum each
    Gaussian's loss change over the union of its base and perturbed
    footprints (:165-179), and give each of its 11 parameters that sum
    times s / eps (:182-188).

    ``image_of_params(p) -> [P,3]`` takes a parameter tensor on the device
    of ``params``; ``footprint_of_params(p) -> [P,k]`` int32 takes numpy
    (``footprint_fn``); ``target`` [P,3]."""
    rng = rng or np.random.default_rng(0)
    p, dev = _host(params)
    n_gauss = p.size // PARAMS_PER_GAUSSIAN
    if eps is None:
        eps = default_param_eps(n_gauss)
    target = np.asarray(target).reshape(-1, 3)

    def pixel_losses(x):
        with torch.no_grad():
            img = image_of_params(torch.from_numpy(x).to(dev))
        return np.abs(img.detach().cpu().numpy().reshape(-1, 3)
                      - target).sum(-1)

    def membership(fp):
        fp = np.asarray(fp)
        m = np.zeros((fp.shape[0], n_gauss), bool)
        px, slot = np.nonzero(fp >= 0)
        m[px, fp[px, slot]] = True
        return m

    base_loss = pixel_losses(p)
    mem_base = membership(footprint_of_params(p))
    grad = np.zeros_like(p, np.float64)
    for _ in range(num_samples):
        s = rng.choice(np.array([-1.0, 1.0], np.float32), p.shape)
        p_plus = p + s * eps
        mem = mem_base | membership(footprint_of_params(p_plus))
        f_diff = mem.T.astype(np.float64) @ (pixel_losses(p_plus)
                                            - base_loss)
        grad += np.repeat(f_diff, PARAMS_PER_GAUSSIAN) * s / eps
    return (grad / num_samples).astype(np.float32)
