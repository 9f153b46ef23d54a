"""Turntable animation (the reference's MAKE_GIF mode, tests/main.cpp:77-115).

Counterpart of ``gvr_tpu/io/turntable.py``: ``num_frames`` frames of an
orthographic camera orbiting the lookat point at ``radius``, ``height``
above it, rendered by the ray marcher of the scene's medium or by
``render_multiscatter``, written as a GIF at ``fps``.
"""

from __future__ import annotations

import math
from typing import Callable, Optional

import numpy as np

from gvr_tpu_torch.cameras import OrthographicCamera
from gvr_tpu_torch.config import RenderConfig
from gvr_tpu_torch.integrators.multiscatter import render_multiscatter
from gvr_tpu_torch.integrators.raymarch import (render_raymarch_gaussians,
                                                render_raymarch_spheres)
from gvr_tpu_torch.io.gif import write_gif
from gvr_tpu_torch.scene.scene import Scene


def render_turntable(scene: Scene, out_path: Optional[str],
                     cfg: RenderConfig = RenderConfig(),
                     lookat=(0.0, 1.0, 0.0), radius: float = 6.0,
                     height: float = 1.0, num_frames: int = 120,
                     fps: float = 30.0, integrator: str = "raymarch",
                     progress: Optional[Callable] = print,
                     device="cuda") -> None:
    """Render the orbit on ``device`` and write it to ``out_path`` (None:
    render only, as the ranks but the first of a distributed job do).
    ``integrator`` 'raymarch' takes the analytic marcher of the medium
    (Gaussians or spheres), 'multiscatter' the Monte Carlo renderer;
    ``progress``, if given, receives a line after each frame."""
    if integrator == "raymarch":
        render = (render_raymarch_gaussians if scene.is_gaussian
                  else render_raymarch_spheres)
    elif integrator == "multiscatter":
        render = render_multiscatter
    else:
        raise ValueError(f"unknown turntable integrator {integrator!r} "
                         f"(use 'raymarch' or 'multiscatter')")
    lookat = np.asarray(lookat, np.float32)
    scene = scene.to(device)
    frames = []
    for frame in range(num_frames):
        angle = 2.0 * math.pi * frame / num_frames
        pos = lookat + np.array([radius * math.sin(angle), height,
                                 radius * math.cos(angle)], np.float32)
        cam = OrthographicCamera.create(pos, lookat, device=device)
        frames.append(render(scene, cam, cfg, device=device))
        if progress:
            progress(f"Frame {frame + 1} / {num_frames} complete.")
    if out_path is not None:
        write_gif(out_path, frames, delay_cs=max(1, round(100.0 / fps)))
