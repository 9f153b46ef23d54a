"""Chunking helpers shared by the integrators (``gvr_tpu/integrators/
common.py``)."""

from __future__ import annotations

import torch

from gvr_tpu_torch.config import RenderConfig

# budget for the [rays, gaussians] intermediates that the plain versions
# build for one chunk on the CPU (the kernels build none)
_ELEM_BUDGET = 1 << 25


def pick_chunk(cfg: RenderConfig, n_primitives: int, device) -> int:
    """Rays per chunk: cfg.ray_chunk, floored at 256 and kept a multiple of
    256.  On the CPU, where the plain versions run, also capped so
    [chunk, N] stays within the element budget."""
    chunk = cfg.ray_chunk
    if torch.device(device).type == "cpu":
        chunk = min(chunk, max(256, _ELEM_BUDGET // max(n_primitives, 1)))
    return max(256, (chunk // 256) * 256)


def ids_to_pixels(ids, width: int):
    """Flat ray/pixel id -> (x, y) integer coords."""
    return ids % width, ids // width
