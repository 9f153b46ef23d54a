"""Command-line entry point: render a Gaussian scene.

Counterpart of ``gvr_tpu/cli.py render``, with the same flags and defaults
(512x512, camera at (0,1,6) looking at (0,1,0), FOV 45 degrees, 256 spp,
step 0.01, 20 environment samples) apart from the TPU-only ``--pallas``,
and with ``--device`` (default cuda):

    python -m gvr_tpu_torch.cli render scene.txt -o out.ppm \
        [--integrator multiscatter|singlescatter|raymarch|pureraymarch|hitmask]

``--trace`` raises (ROADMAP Queue 1, tooling).  ``main`` returns the
command's result (the ``--stats`` dict for render).  The animate and fit
commands wait for their port (ROADMAP Queue 1).
"""

from __future__ import annotations

import argparse
import math
import time

INTEGRATORS = ("multiscatter", "singlescatter", "raymarch", "pureraymarch",
               "hitmask")


def renderer(integrator: str):
    """The render function (scene, camera, cfg, device=, stats=) of one of
    INTEGRATORS."""
    from gvr_tpu_torch.integrators.freeflight import render_single_scatter
    from gvr_tpu_torch.integrators.multiscatter import render_multiscatter
    from gvr_tpu_torch.integrators.raymarch import (
        render_pure_raymarch, render_raymarch_gaussians)
    from gvr_tpu_torch.integrators.test_hit import render_hit_mask
    return {"multiscatter": render_multiscatter,
            "singlescatter": render_single_scatter,
            "raymarch": render_raymarch_gaussians,
            "pureraymarch": render_pure_raymarch,
            "hitmask": render_hit_mask}[integrator]


def make_camera(args, device):
    from gvr_tpu_torch.cameras import OrthographicCamera, PinholeCamera
    if args.camera == "pinhole":
        return PinholeCamera.create(args.pos, args.lookat,
                                    math.radians(args.fov), device=device)
    return OrthographicCamera.create(args.pos, args.lookat, device=device)


def cmd_render(args):
    from gvr_tpu_torch.config import RenderConfig, Solver
    from gvr_tpu_torch.io.ppm import write_ppm
    from gvr_tpu_torch.scene.scene import load_scene

    cfg = RenderConfig(width=args.width, height=args.height, spp=args.spp,
                       step_size=args.step_size,
                       env_samples=args.env_samples,
                       solver=Solver(args.solver), seed=args.seed,
                       engine=args.engine)
    if args.trace:
        raise NotImplementedError(
            "--trace is not ported yet (ROADMAP Queue 1, utils/profiling)")
    scene = load_scene(args.scene, device=args.device)
    camera = make_camera(args, args.device)
    stats = {} if args.stats else None
    t0 = time.time()
    kw = {"progress": args.verbose} if args.integrator == "multiscatter" \
        else {}
    img = renderer(args.integrator)(scene, camera, cfg, device=args.device,
                                    stats=stats, **kw)
    print(f"Render time: {time.time() - t0:.3f} seconds")
    if stats is not None and args.integrator != "multiscatter":
        extra = "".join(f", {k} {stats[k]}" for k in (
            "paths", "k3_launches", "n_steps", "steps", "shadow_steps",
            "chunks") if k in stats)
        print(f"[render] {args.integrator}: {stats['seconds']:.3f} s on "
              f"{stats['device']}, chunk {stats['chunk']}{extra}")
    elif stats is not None:
        extra = (f", {stats['iterations']} iterations"
                 if stats["kernel"] != "mega" else "")
        if stats["engine"] == "grid":
            extra += f", grid build {stats['grid_seconds']:.3f} s"
        extra += f", chunk {stats['chunk']}"
        print(f"[render] engine {stats['engine']} ({stats['kernel']} "
              f"kernel): {stats['paths']} paths, "
              f"{stats['bounce_evals']} bounce evaluations in "
              f"{stats['seconds']:.3f} s on {stats['device']}: "
              f"{stats['paths'] / stats['seconds'] / 1e6:.3f} Mpaths/s{extra}")
    write_ppm(args.output, img)
    print(f"wrote {args.output}")
    return stats


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="gvr_tpu_torch",
        description="Gaussian volume renderer (PyTorch/CUDA)")
    sub = ap.add_subparsers(dest="cmd", required=True)
    pr = sub.add_parser("render", help="forward render to PPM")
    pr.add_argument("scene", help="scene text file (GMM format)")
    pr.add_argument("--width", type=int, default=512)
    pr.add_argument("--height", type=int, default=512)
    pr.add_argument("--camera", choices=["pinhole", "orthographic"],
                    default="pinhole")
    pr.add_argument("--pos", type=float, nargs=3, default=[0.0, 1.0, 6.0])
    pr.add_argument("--lookat", type=float, nargs=3,
                    default=[0.0, 1.0, 0.0])
    pr.add_argument("--fov", type=float, default=45.0, help="degrees")
    pr.add_argument("--seed", type=int, default=0)
    pr.add_argument("-o", "--output", default="output.ppm")
    pr.add_argument("--integrator", default="multiscatter",
                    choices=INTEGRATORS)
    pr.add_argument("--spp", type=int, default=256)
    # --step-size and --env-samples steer the ray marchers only
    pr.add_argument("--step-size", dest="step_size", type=float,
                    default=0.01)
    pr.add_argument("--env-samples", dest="env_samples", type=int,
                    default=20)
    pr.add_argument("--solver", default="analytic_newton",
                    choices=["newton", "bisection", "analytic_newton",
                             "analytic_bisection", "uniform"])
    pr.add_argument("--engine", default="auto",
                    choices=["auto", "dense", "grid"],
                    help="auto: the dense engine up to 2000 Gaussians, the "
                    "grid engine above (dense where the grid refuses a scene "
                    "by S_CAP_MAX); dense: the megakernel up to 2048 "
                    "Gaussians, the big-N engine (kernels K4/K5) above, up "
                    "to 24576; the solvers bisection, analytic_bisection "
                    "and uniform take the dense XLA engine under auto and "
                    "dense, and grid refuses them")
    pr.add_argument("--stats", action="store_true",
                    help="print the seconds and the chunk; for multiscatter "
                    "the engine and kernel, paths, bounce evaluations, "
                    "Mpaths/s and the wavefront iterations; for the marchers "
                    "the steps")
    pr.add_argument("--trace", default=None, metavar="DIR",
                    help="profiler trace (not ported yet)")
    pr.add_argument("-v", "--verbose", action="store_true")
    pr.add_argument("--device", default="cuda",
                    help="torch device to render on (cuda, cuda:N or cpu)")
    pr.set_defaults(fn=cmd_render)
    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    main()
