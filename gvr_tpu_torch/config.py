"""Runtime configuration for renders.

The counterpart of ``gvr_tpu/config.py`` without its TPU layout knobs
(``pallas``, ``block``, ``mxu_coeffs``, ``tau_bf16``, ``pool_regen``): the
CUDA megakernel and the grid wavefront are always the pooled ones, and the
kernels fix their own block geometry.  ``wavefront`` is kept: it picks the
dense engine's kernel path, as in the JAX package.  ``FitConfig`` is the
JAX package's, field for field.
"""

from __future__ import annotations

import dataclasses
import enum


class Solver(enum.Enum):
    """Free-flight distance solver (reference ``distance_solvers.h``).

    NEWTON and ANALYTIC_NEWTON run the kernels (bracketed Newton +
    Illinois, with the optional erfinv finisher); the others run the
    dense XLA engine, as in the JAX package on its accelerator
    (``gvr_tpu/integrators/multiscatter.py:452-465``).
    """

    NEWTON = "newton"
    BISECTION = "bisection"
    ANALYTIC_NEWTON = "analytic_newton"
    ANALYTIC_BISECTION = "analytic_bisection"
    UNIFORM = "uniform"


KERNEL_SOLVERS = (Solver.NEWTON, Solver.ANALYTIC_NEWTON)


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    """Static knobs of the integrators; defaults mirror the
    reference's ``tests/main.cpp`` and ``gvr_tpu.config.RenderConfig``."""

    width: int = 512
    height: int = 512
    spp: int = 256                 # samples per pixel
    min_scatter: int = 5           # bounces before Russian roulette
    rr_cap: float = 0.9            # RR survival probability cap
    rr_tail_after: int = 16        # from this bounce on, RR caps at ...
    rr_cap_tail: float = 0.5       # ... this survival probability
    max_bounces: int = 64          # hard bound on a path's length
    step_size: float = 0.01        # ray-march step (the ray marchers)
    env_samples: int = 20          # env direction samples (ray marchers)
    solver: Solver = Solver.ANALYTIC_NEWTON
    solver_iters: int = 12         # Newton + Illinois trip count
    solver_finisher: bool = False  # analytic erfinv finisher
    # grid engine: Newton + Illinois steps of the in-cell solve (the
    # bracket is one cell crossing and its erfinv finisher is always on)
    grid_solver_iters: int = 6
    ray_chunk: int = 1 << 16       # pixels per kernel launch
    seed: int = 0                  # base RNG seed
    # per-ray candidate compaction (0 = off): the XLA engine and single
    # scatter solve on each ray's candidate_k nearest-entering Gaussians;
    # the kernel engines ignore it, as the JAX package's do
    candidate_k: int = 0
    # the dense engine's kernel path up to MAX_PALLAS_GAUSSIANS Gaussians:
    # 'mega' runs the whole sample/bounce loop in one persistent kernel
    # (K1); 'step' launches the fused bounce kernel (K2) once a wavefront
    # iteration.  Above that 'step' takes the big-N kernels, as in JAX.
    wavefront: str = "mega"
    engine: str = "auto"           # 'auto' | 'dense' | 'grid'

    def __post_init__(self):
        if self.wavefront not in ("mega", "step"):
            raise ValueError(f"wavefront must be 'mega' or 'step', "
                             f"got {self.wavefront!r}")
        if self.engine not in ("auto", "dense", "grid"):
            raise ValueError(f"engine must be 'auto'/'dense'/'grid', "
                             f"got {self.engine!r}")

    def replace(self, **kw) -> "RenderConfig":
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass(frozen=True)
class FitConfig:
    """Inverse-rendering configuration (reference ``SFDDConfig``,
    ``inverse_integrator.h:52-57``; ``gvr_tpu/config.py:176-192``)."""

    max_iters: int = 1000
    save_every: int = 25
    lr: float = 1e-2
    # MC gradient samples per pixel per loss buffer (inverse/fit)
    spp: int = 2
    # Rademacher perturbations per iteration of the SFD validation mode
    # (inverse/sfd)
    num_stoch_samples: int = 4
    checkpoint_every: int = 100
    out_dir: str = "./fit_output"
    seed: int = 0                  # minibatch and MC stream base seed
