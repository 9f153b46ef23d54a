"""Where a render's time goes: torch.profiler over one warm render of a
generated scene; with ``--fit``, over one warm iteration of the fit.

    python -m gvr_tpu_torch.profile_render [--gaussians 10000] [--size 512]
        [--spp 16] [--engine auto|dense|grid] [--wavefront mega|step]
        [--solver analytic_newton] [--integrator multiscatter]
    python -m gvr_tpu_torch.profile_render --fit [--gaussians 250]
        [--size 128]

Renders ``random_gaussian_scene(gaussians, seed=0)`` with the default
camera and the given engine (auto: the grid above 2,000 Gaussians; dense
above 2,048: the big-N kernels K4/K5), dense kernel path (``--wavefront
step``: the step wavefront, K2 once an iteration, up to 256 Gaussians),
solver (bisection, analytic_bisection and uniform take the dense XLA
engine) and integrator (the CLI's, with its default step and environment
samples) twice unprofiled, the second giving the warm render seconds,
then once under torch.profiler, and prints: the
warm and profiled render seconds, the device time of all kernels and
copies and its share of the profiled render (``busy_share``; the rest is
idle, bound by the host), kernel launches in all and per wavefront
iteration, the ops that take the most device time and the most host
time, and the render loop's spans (``utils.profiling``: render.prepare,
chunk, wavefront.iteration and its wavefront.live_read,
render.readback...) by their self time, with their counters.  On the
marchers "iterations" are the march steps.

``--fit`` profiles one fit iteration instead: the scene's packed
parameters perturbed by N(0, 0.1) (numpy seed 7), a 4,096-pixel batch of
the size^2 image, 4 bounces, the 'l2_dual' loss at spp 2 and an Adam
step, as one iteration of ``inverse/fit.fit_gaussians`` at the CLI's
settings; three warm iterations give the seconds an iteration, then one
runs under torch.profiler (launches, device time and its share of the
profiled iteration, peak device memory).
"""

from __future__ import annotations

import argparse
import json
import math


def _row(e):
    return (f"{e.device_time_total / 1e3:12.3f} ms dev "
            f"{e.self_cpu_time_total / 1e3:12.3f} ms host {e.count:8d} calls"
            f"  {e.key[:100]}")


def _summary(prof, top: int) -> dict:
    """The device busy ms, kernel launches and top rows by device and by
    host time of a finished torch.profiler run."""
    from torch.autograd import DeviceType
    rows = prof.key_averages()
    by_dev = sorted(rows, key=lambda e: -e.device_time_total)[:top]
    by_cpu = sorted(rows, key=lambda e: -e.self_cpu_time_total)[:top]
    # device-side rows (kernels, copies) only: an op's row repeats the time
    # of the kernels it launched
    return dict(
        device_busy_ms=sum(e.device_time_total for e in rows
                           if e.device_type != DeviceType.CPU) / 1e3,
        kernel_launches=sum(e.count for e in rows
                            if e.key == "cudaLaunchKernel"),
        by_device=[_row(e) for e in by_dev if e.device_time_total > 0],
        by_host=[_row(e) for e in by_cpu])


def _spans(top: int) -> dict:
    """The recorder's spans (``utils.profiling.recorded``) summed by
    name, the top by self time (their duration less their children's),
    and its counters summed over the renders."""
    from gvr_tpu_torch.utils.profiling import recorded
    rec = recorded()
    own = rec.self_ns()
    by_name = {}
    for s in rec.spans:
        n, total, self_ns = by_name.get(s.name, (0, 0, 0))
        by_name[s.name] = (n + 1, total + s.end_ns - s.start_ns,
                           self_ns + own[s.id])
    rows = sorted(by_name.items(), key=lambda kv: -kv[1][2])[:top]
    return dict(
        by_span=[f"{self_ns / 1e6:12.3f} ms self {total / 1e6:12.3f} ms "
                 f"total {n:8d} spans  {name}"
                 for name, (n, total, self_ns) in rows],
        span_self_ms={name: self_ns / 1e6
                      for name, (_, _, self_ns) in rows},
        counters=rec.totals())


def profile_render(gaussians: int = 10_000, size: int = 512, spp: int = 16,
                   top: int = 25, device: str = "cuda",
                   engine: str = "auto", solver: str = "analytic_newton",
                   integrator: str = "multiscatter",
                   wavefront: str = "mega") -> dict:
    """Profile one render after two unprofiled ones; returns the summary
    that ``main`` prints (times in ms unless named seconds)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from gvr_tpu_torch.cameras import PinholeCamera
    from gvr_tpu_torch.cli import renderer
    from gvr_tpu_torch.config import RenderConfig, Solver
    from gvr_tpu_torch.scene.generators import random_gaussian_scene
    from gvr_tpu_torch.scene.scene import parse_gmm
    from gvr_tpu_torch.utils.profiling import recorded

    scene = parse_gmm(random_gaussian_scene(gaussians, seed=0),
                      device=device)
    cam = PinholeCamera.create([0, 1, 6], [0, 1, 0], math.radians(45.0),
                               device=device)
    cfg = RenderConfig(width=size, height=size, spp=spp, engine=engine,
                       solver=Solver(solver), wavefront=wavefront)
    render = renderer(integrator)
    stats = {}
    for _ in range(2):
        render(scene, cam, cfg, device=device, stats=stats)
    warm_s = stats["seconds"]
    activities = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    prof_stats = {}
    recorded().clear()
    with profile(activities=activities) as prof:
        render(scene, cam, cfg, device=device, stats=prof_stats)
    summ = _summary(prof, top)
    iters = prof_stats.get("iterations", prof_stats.get("steps", 0))
    return dict(
        engine=prof_stats.get("engine"), kernel=prof_stats.get("kernel"),
        integrator=integrator, gaussians=gaussians, size=size, spp=spp,
        warm_seconds=warm_s, profiled_seconds=prof_stats["seconds"],
        iterations=iters,
        busy_share=summ["device_busy_ms"] / 1e3 / prof_stats["seconds"],
        launches_per_iteration=(summ["kernel_launches"] / iters if iters
                                else None), **summ, **_spans(top))


def profile_fit(gaussians: int = 250, size: int = 128, top: int = 25,
                device: str = "cuda", batch: int = 4096, bounces: int = 4,
                spp: int = 2) -> dict:
    """Profile one fit iteration after three timed ones; returns the
    summary ``main`` prints (times in ms unless named seconds)."""
    import time

    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from gvr_tpu_torch.cameras import PinholeCamera
    from gvr_tpu_torch.inverse.fit import _pixel_rays, fit_loss
    from gvr_tpu_torch.scene.gaussians import GaussianMixture
    from gvr_tpu_torch.scene.generators import random_gaussian_scene
    from gvr_tpu_torch.scene.scene import parse_gmm

    scene = parse_gmm(random_gaussian_scene(gaussians, seed=0),
                      device=device)
    p = scene.medium.pack_parameters().cpu().numpy()
    p = p + np.random.default_rng(7).normal(0, 0.1, p.shape) \
        .astype(np.float32)
    params = torch.tensor(p, device=device, requires_grad=True)
    opt = torch.optim.Adam([params], lr=1e-2)
    cam = PinholeCamera.create([0, 1, 6], [0, 1, 0], math.radians(45.0),
                               device=device)
    target = torch.full((batch, 3), 0.5, device=device)
    sync = (torch.cuda.synchronize if torch.device(device).type == "cuda"
            else lambda: None)

    def iteration(it):
        ids = torch.from_numpy(np.random.default_rng(it).integers(
            0, size * size, batch, dtype=np.int32)).to(device)
        o, d, rng_ids = _pixel_rays(cam, size, size, ids)
        opt.zero_grad(set_to_none=True)
        fit_loss(params, scene, o, d, rng_ids, target, n_bounces=bounces,
                 spp=spp, seed=it).backward()
        opt.step()
        sync()

    iteration(0)
    t0 = time.perf_counter()
    for it in range(1, 4):
        iteration(it)
    warm_s = (time.perf_counter() - t0) / 3
    activities = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        activities.append(ProfilerActivity.CUDA)
        torch.cuda.reset_peak_memory_stats()
    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        iteration(4)
        prof_s = time.perf_counter() - t0
    summ = _summary(prof, top)
    return dict(
        fit=True, gaussians=gaussians, size=size, batch=batch,
        bounces=bounces, spp=spp, warm_seconds_per_iteration=warm_s,
        profiled_seconds=prof_s,
        busy_share=summ["device_busy_ms"] / 1e3 / prof_s,
        peak_memory_gib=(torch.cuda.max_memory_allocated() / 2**30
                         if torch.device(device).type == "cuda" else None),
        **summ)


def main(argv=None):
    from gvr_tpu_torch.cli import INTEGRATORS
    from gvr_tpu_torch.config import Solver

    ap = argparse.ArgumentParser(prog="gvr_tpu_torch.profile_render",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--fit", action="store_true",
                    help="profile a fit iteration (default 250 Gaussians, "
                    "128^2) instead of a render")
    ap.add_argument("--gaussians", type=int, default=None)
    ap.add_argument("--size", type=int, default=None)
    ap.add_argument("--spp", type=int, default=16)
    ap.add_argument("--top", type=int, default=25)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--engine", default="auto",
                    choices=["auto", "dense", "grid"])
    ap.add_argument("--wavefront", default="mega", choices=["mega", "step"])
    ap.add_argument("--solver", default="analytic_newton",
                    choices=[s.value for s in Solver])
    ap.add_argument("--integrator", default="multiscatter",
                    choices=INTEGRATORS)
    args = vars(ap.parse_args(argv))
    if args.pop("fit"):
        res = profile_fit(args["gaussians"] or 250, args["size"] or 128,
                          args["top"], args["device"])
    else:
        args["gaussians"] = args["gaussians"] or 10_000
        args["size"] = args["size"] or 512
        res = profile_render(**args)
    rows = ("by_device", "by_host", "by_span")
    for key in rows:
        if key in res:
            print(f"--- by {key[3:]} time" + (" (self)" if key == "by_span"
                                              else ""))
            print("\n".join(res[key]))
    print(json.dumps({k: v for k, v in res.items() if k not in rows}))
    return res


if __name__ == "__main__":
    main()
