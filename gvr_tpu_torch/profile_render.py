"""Where a render's time goes: torch.profiler over one warm render of a
generated scene.

    python -m gvr_tpu_torch.profile_render [--gaussians 10000] [--size 512]
        [--spp 16] [--engine auto|dense|grid] [--solver analytic_newton]
        [--integrator multiscatter]

Renders ``random_gaussian_scene(gaussians, seed=0)`` with the default
camera and the given engine (auto: the grid above 2,000 Gaussians; dense
above 2,048: the big-N kernels K4/K5), solver (bisection,
analytic_bisection and uniform take the dense XLA engine) and integrator
(the CLI's, with its default step and environment samples) twice
unprofiled, the second giving
the warm render seconds, then once under torch.profiler, and prints: the
warm and profiled render seconds, the device time of all kernels and
copies and its share of the warm render (the device's busy share; the
rest is idle, bound by the host), kernel launches in all and per
wavefront iteration, and the ops that take the most device time and the
most host time.  On the marchers "iterations" are the march steps.
"""

from __future__ import annotations

import argparse
import json
import math


def _row(e):
    return (f"{e.device_time_total / 1e3:12.3f} ms dev "
            f"{e.self_cpu_time_total / 1e3:12.3f} ms host {e.count:8d} calls"
            f"  {e.key[:100]}")


def profile_render(gaussians: int = 10_000, size: int = 512, spp: int = 16,
                   top: int = 25, device: str = "cuda",
                   engine: str = "auto", solver: str = "analytic_newton",
                   integrator: str = "multiscatter") -> dict:
    """Profile one render after two unprofiled ones; returns the summary
    that ``main`` prints (times in ms unless named seconds)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from gvr_tpu_torch.cameras import PinholeCamera
    from gvr_tpu_torch.cli import renderer
    from gvr_tpu_torch.config import RenderConfig, Solver
    from gvr_tpu_torch.scene.generators import random_gaussian_scene
    from gvr_tpu_torch.scene.scene import parse_gmm

    scene = parse_gmm(random_gaussian_scene(gaussians, seed=0),
                      device=device)
    cam = PinholeCamera.create([0, 1, 6], [0, 1, 0], math.radians(45.0),
                               device=device)
    cfg = RenderConfig(width=size, height=size, spp=spp, engine=engine,
                       solver=Solver(solver))
    render = renderer(integrator)
    stats = {}
    for _ in range(2):
        render(scene, cam, cfg, device=device, stats=stats)
    warm_s = stats["seconds"]
    activities = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    prof_stats = {}
    with profile(activities=activities) as prof:
        render(scene, cam, cfg, device=device, stats=prof_stats)
    rows = prof.key_averages()
    # device-side rows (kernels, copies) only: an op's row repeats the time
    # of the kernels it launched
    busy_ms = sum(e.device_time_total for e in rows
                  if e.device_type != DeviceType.CPU) / 1e3
    launches = sum(e.count for e in rows if e.key == "cudaLaunchKernel")
    iters = prof_stats.get("iterations", prof_stats.get("steps", 0))
    by_dev = sorted(rows, key=lambda e: -e.device_time_total)[:top]
    by_cpu = sorted(rows, key=lambda e: -e.self_cpu_time_total)[:top]
    return dict(
        engine=prof_stats.get("engine"), kernel=prof_stats.get("kernel"),
        integrator=integrator, gaussians=gaussians, size=size, spp=spp,
        warm_seconds=warm_s, profiled_seconds=prof_stats["seconds"],
        iterations=iters, device_busy_ms=busy_ms,
        busy_share_of_warm=busy_ms / 1e3 / warm_s,
        kernel_launches=launches,
        launches_per_iteration=launches / iters if iters else None,
        by_device=[_row(e) for e in by_dev if e.device_time_total > 0],
        by_host=[_row(e) for e in by_cpu])


def main(argv=None):
    from gvr_tpu_torch.cli import INTEGRATORS
    from gvr_tpu_torch.config import Solver

    ap = argparse.ArgumentParser(prog="gvr_tpu_torch.profile_render",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--gaussians", type=int, default=10_000)
    ap.add_argument("--size", type=int, default=512)
    ap.add_argument("--spp", type=int, default=16)
    ap.add_argument("--top", type=int, default=25)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--engine", default="auto",
                    choices=["auto", "dense", "grid"])
    ap.add_argument("--solver", default="analytic_newton",
                    choices=[s.value for s in Solver])
    ap.add_argument("--integrator", default="multiscatter",
                    choices=INTEGRATORS)
    args = ap.parse_args(argv)
    res = profile_render(**vars(args))
    for key in ("by_device", "by_host"):
        print(f"--- by {key[3:]} time")
        print("\n".join(res[key]))
    print(json.dumps({k: v for k, v in res.items()
                      if k not in ("by_device", "by_host")}))
    return res


if __name__ == "__main__":
    main()
