"""Counter-based RNG keyed by (pixel, sample, bounce).

Counterpart of ``gvr_tpu/ops/sampling.py:path_uniforms``, bit for bit: the
same splitmix32 chain (one copy, ``kernels/rng.uniform_cols``) and the same
23-bit mantissa truncation.
"""

from __future__ import annotations

import torch

from gvr_tpu_torch.kernels.rng import planes_uniforms, uniform_cols


def path_uniforms(pixel_id, sample, bounce, n: int, seed: int = 0):
    """[..., n] float32 uniforms in [0,1) for integer pixel ids [...];
    sample and bounce broadcast against them or are ints."""
    return torch.stack(uniform_cols(pixel_id, sample, bounce, n, seed),
                       dim=-1)


def dir_from_xi(xi: torch.Tensor) -> torch.Tensor:
    """Uniform sphere direction [..., 3] from two uniforms [..., 2]
    (integrator.h:32-44): theta = 2 pi xi0, cos phi = 1 - 2 xi1."""
    theta = (2.0 * torch.pi) * xi[..., 0]
    cphi = 1.0 - 2.0 * xi[..., 1]
    sphi = torch.sqrt(torch.clamp(1.0 - cphi * cphi, min=0.0))
    return torch.stack([sphi * torch.cos(theta), sphi * torch.sin(theta),
                        cphi], dim=-1)


def uniform_planes(pid: torch.Tensor, sample, bounce, n: int,
                   seed: int = 0) -> torch.Tensor:
    """[n, *pid.shape] float32 uniforms keyed by (pid, sample, bounce), bit
    for bit ``path_uniforms``, drawn by K3 (``kernels/rng.planes_uniforms``):
    the kernel for a CUDA pid, its plain version for a CPU one.  sample and
    bounce are ints or integer tensors that broadcast against pid."""
    pid = pid.to(torch.int32).contiguous()

    def full(x):
        return torch.broadcast_to(
            torch.as_tensor(x, dtype=torch.int32, device=pid.device),
            pid.shape).contiguous()

    return planes_uniforms(pid, full(sample),
                           bounce if isinstance(bounce, int) else full(bounce),
                           n, seed)
