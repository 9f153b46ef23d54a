"""gvr_tpu_torch: the PyTorch/CUDA port of gvr_tpu for NVIDIA Hopper.

A second package beside the JAX reference ``gvr_tpu``: the same module
paths, PyTorch tensors with an explicit device, and the reference's Pallas
kernels rewritten by hand in CUDA C++ for sm_90a (``csrc/``), each with a
plain PyTorch version beside it.  It covers the multiscatter main path:
scene text -> GaussianMixture -> camera -> ``render_multiscatter`` -> PPM,
through the pooled megakernel up to 2,000 Gaussians, the grid engine
(``accel/grid``, ``integrators/gridscatter``) above, and the big-N dense
engine (``kernels/pathtrace_big``) where the JAX package takes it; the
solvers the kernels do not implement take the dense XLA engine (plain
PyTorch, ``ops/transmittance`` and ``ops/solvers``), and the other forward
integrators (``integrators/freeflight``, ``raymarch``, ``test_hit``) are
plain PyTorch too.  Inverse rendering (``inverse/``: the Adam fit of the
11-parameter codec through the differentiable estimator
``multiscatter_radiance_diff``, attribution and SFD; ``cli fit``) runs
under autograd, its draws from the RNG kernel and its renders through
the megakernel.  ``parallel/`` runs the render and the fit data parallel
over the ranks of a ``torch.distributed`` job and shards the mixture over
a Gaussian axis (tensor parallel).  It never imports jax or gvr_tpu.
"""

from gvr_tpu_torch.cameras import OrthographicCamera, PinholeCamera
from gvr_tpu_torch.config import RenderConfig, Solver
from gvr_tpu_torch.scene.gaussians import GaussianMixture
from gvr_tpu_torch.scene.scene import Scene, load_gmm, load_scene, parse_gmm

__all__ = [
    "GaussianMixture",
    "OrthographicCamera",
    "PinholeCamera",
    "RenderConfig",
    "Scene",
    "Solver",
    "load_gmm",
    "load_scene",
    "parse_gmm",
]
