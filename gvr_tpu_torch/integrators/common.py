"""Chunking helpers shared by the integrators (``gvr_tpu/integrators/
common.py``)."""

from __future__ import annotations

from typing import Callable

import torch

from gvr_tpu_torch.config import RenderConfig

# budget for the [rays, gaussians] intermediates of one chunk: those of the
# plain versions on the CPU, and on any device those of the dense paths
# (the XLA engine, single scatter, the ray marchers, the hit mask), which
# hold ~11 such arrays at once
_ELEM_BUDGET = 1 << 25


def pick_chunk(cfg: RenderConfig, n_primitives: int, device,
               dense: bool = False) -> int:
    """Rays per chunk: cfg.ray_chunk, floored at 256 and kept a multiple of
    256.  Where [chunk, N] arrays are built, that is on the CPU, where the
    plain versions run, and for a ``dense`` path on any device, also
    capped so [chunk, n_primitives] stays within the element budget.  The
    kernel engines build none and take their chunk whole on the card."""
    chunk = cfg.ray_chunk
    if dense or torch.device(device).type == "cpu":
        chunk = min(chunk, max(256, _ELEM_BUDGET // max(n_primitives, 1)))
    return max(256, (chunk // 256) * 256)


def image_chunk(cfg: RenderConfig, n_primitives: int, device) -> int:
    """The chunk of a dense path over the image: ``pick_chunk(dense=True)``
    cut to the image's pixels rounded up to 256 (a larger one would only
    pad)."""
    return min(pick_chunk(cfg, n_primitives, device, dense=True),
               -(-cfg.width * cfg.height // 256) * 256)


def render_chunked(radiance_fn: Callable, num_rays: int, chunk: int,
                   device) -> torch.Tensor:
    """radiance_fn(ids [chunk] int32) -> [chunk, 3] over all ray ids in
    fixed-size chunks, the last padded with repeats of the last id, as the
    JAX package pads it.  Returns [num_rays, 3] float32 on ``device``."""
    out = torch.empty((num_rays, 3), dtype=torch.float32, device=device)
    for start in range(0, num_rays, chunk):
        ids = torch.clamp(torch.arange(start, start + chunk,
                                       dtype=torch.int32, device=device),
                          max=num_rays - 1)
        stop = min(start + chunk, num_rays)
        out[start:stop] = radiance_fn(ids)[: stop - start]
    return out


def ids_to_pixels(ids, width: int):
    """Flat ray/pixel id -> (x, y) integer coords."""
    return ids % width, ids // width
