"""Render observability: timing spans, throughput and the profiler trace.

Counterpart of ``gvr_tpu/utils/profiling.py``.  ``RenderStats`` collects
named ``Span``s (``render_multiscatter`` adds a ``chunk`` span a chunk
and a ``render_multiscatter`` span) and prints them in the JAX package's
format; it is also the dict of the last render's summary that the
integrators fill (engine, kernel, seconds, paths...).  ``device_trace``
records the kernels' timeline with ``torch.profiler`` into a Chrome trace
(the CLI's ``--trace``); unlike the JAX package's, it raises where the
profiler fails.  ``path_statistics`` traces a subsample of pixel-centre
paths with the multiscatter estimator's survival rules and counts their
rays and scatter events, the bounce histogram behind the Mrays/s of
``gvr_tpu_torch.bench_series``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from gvr_tpu_torch.config import RenderConfig, Solver
from gvr_tpu_torch.integrators.multiscatter import _roulette
from gvr_tpu_torch.integrators.test_hit import pixel_rays
from gvr_tpu_torch.kernels.rng import BOUNCE_DRAWS
from gvr_tpu_torch.ops.sampling import dir_from_xi, uniform_planes
from gvr_tpu_torch.ops.solvers import sample_free_flight
from gvr_tpu_torch.ops.transmittance import albedo_at_from_rg, tau_coeffs

TRACE_FILE = "trace.json"


@dataclasses.dataclass
class Span:
    name: str
    seconds: float
    extra: Dict


class RenderStats(dict):
    """Named spans with a compact report (``report``, ``json``: the JAX
    package's format), and, as a dict, the summary of the last render
    (the keys an integrator's ``stats=`` dict receives)."""

    def __init__(self):
        super().__init__()
        self.spans: List[Span] = []

    @contextlib.contextmanager
    def span(self, name: str, **extra):
        t0 = time.time()
        yield
        self.spans.append(Span(name, time.time() - t0, extra))

    def add(self, name: str, seconds: float, **extra):
        self.spans.append(Span(name, seconds, extra))

    def report(self) -> str:
        lines = []
        for s in self.spans:
            kv = " ".join(f"{k}={v}" for k, v in s.extra.items())
            lines.append(f"[gvr] {s.name}: {s.seconds:.3f}s {kv}".rstrip())
        return "\n".join(lines)

    def json(self) -> str:
        return json.dumps([dataclasses.asdict(s) for s in self.spans])


@contextlib.contextmanager
def device_trace(log_dir: Optional[str]):
    """Record the work inside the context with ``torch.profiler`` (CPU
    activity, and CUDA activity where a card is visible) and write its
    Chrome trace to ``log_dir/trace.json``.  A no-op when log_dir is
    empty; raises where the profiler cannot start (one is running
    already: a second would crash the process) or cannot export."""
    if not log_dir:
        yield
        return
    if torch.autograd.profiler._is_profiler_enabled:
        raise RuntimeError("device_trace: a profiler is running already")
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        yield
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(log_dir, TRACE_FILE))


def mrays_per_sec(n_rays: int, seconds: float) -> float:
    return n_rays / max(seconds, 1e-9) / 1e6


def path_statistics(scene, camera, cfg: RenderConfig,
                    sample_pixels: int = 16384, device="cuda") -> dict:
    """{'rays_per_path', 'mean_scatter_events'} over at most
    ``sample_pixels`` pixel-centre paths spread over the image (sample 0):
    each bounce adds a ray for every live path and a shadow ray for each
    one that scatters; the throughput decays by the albedo and Russian
    roulette ends paths as in the wavefront.  The count holds [n, N]
    arrays, so n is capped by an element budget."""
    scene = scene.to(device)
    camera = camera.to(device)
    gmm = scene.medium
    budget = max(256, (3 << 25) // max(gmm.n, 1))
    n = min(sample_pixels, budget, cfg.width * cfg.height)
    ids = torch.from_numpy(np.linspace(0, cfg.width * cfg.height - 1, n,
                                       dtype=np.int32)).to(device)
    o, d = pixel_rays(camera, cfg, ids)
    thr = torch.ones((n, 3), dtype=torch.float32, device=device)
    alive = torch.ones(n, dtype=torch.bool, device=device)
    rays = bounces = 0
    for bounce in range(cfg.max_bounces):
        if not bool(alive.any()):
            break
        rg = tau_coeffs(gmm, o, d)
        xi = uniform_planes(ids, 0, bounce, BOUNCE_DRAWS, cfg.seed)
        target = -torch.log(torch.clamp(1.0 - xi[0], min=1e-12))
        t_sc, scattered = sample_free_flight(
            rg, target, cfg.solver, cfg.solver_iters,
            xi[8] if cfg.solver == Solver.UNIFORM else None,
            finisher=cfg.solver_finisher)
        hits = alive & scattered
        rays += int(alive.sum()) + int(hits.sum())
        bounces += int(hits.sum())
        t_pos = torch.clamp(t_sc, min=0.0)
        albedo = albedo_at_from_rg(rg, gmm.albedo, t_pos)
        thr_n, killed = _roulette(cfg, thr, albedo, bounce, xi[5])
        alive = hits & ~killed
        thr = torch.where(alive[:, None], thr_n, thr)
        o = o + t_pos[:, None] * d
        d = dir_from_xi(xi[6:8].T)
    return {"rays_per_path": rays / n, "mean_scatter_events": bounces / n}
