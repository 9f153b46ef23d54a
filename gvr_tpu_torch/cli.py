"""Command-line entry point: render a scene with the multiscatter integrator.

Counterpart of ``gvr_tpu/cli.py render``, with the same flags and defaults
(512x512, camera at (0,1,6) looking at (0,1,0), FOV 45 degrees, 256 spp)
apart from the TPU-only ``--pallas``, and with ``--device`` (default cuda):

    python -m gvr_tpu_torch.cli render scene.txt -o out.ppm

Only ``--integrator multiscatter`` is ported; the others raise, as does
``--trace``.  ``main`` returns the command's result (the ``--stats`` dict
for render).  The animate and fit commands wait for their port (ROADMAP
Queue 1).
"""

from __future__ import annotations

import argparse
import math
import time

INTEGRATORS = ("multiscatter", "singlescatter", "raymarch", "pureraymarch",
               "hitmask")


def make_camera(args, device):
    from gvr_tpu_torch.cameras import OrthographicCamera, PinholeCamera
    if args.camera == "pinhole":
        return PinholeCamera.create(args.pos, args.lookat,
                                    math.radians(args.fov), device=device)
    return OrthographicCamera.create(args.pos, args.lookat, device=device)


def cmd_render(args):
    from gvr_tpu_torch.config import RenderConfig, Solver
    from gvr_tpu_torch.integrators.multiscatter import render_multiscatter
    from gvr_tpu_torch.io.ppm import write_ppm
    from gvr_tpu_torch.scene.scene import load_scene

    if args.integrator != "multiscatter":
        raise NotImplementedError(
            f"--integrator {args.integrator} is not ported yet (ROADMAP "
            f"Queue 1, raymarch/freeflight/test_hit); use multiscatter")
    cfg = RenderConfig(width=args.width, height=args.height, spp=args.spp,
                       solver=Solver(args.solver), seed=args.seed,
                       engine=args.engine)
    if args.trace:
        raise NotImplementedError(
            "--trace is not ported yet (ROADMAP Queue 1, utils/profiling)")
    scene = load_scene(args.scene, device=args.device)
    camera = make_camera(args, args.device)
    stats = {} if args.stats else None
    t0 = time.time()
    img = render_multiscatter(scene, camera, cfg, device=args.device,
                              progress=args.verbose, stats=stats)
    print(f"Render time: {time.time() - t0:.3f} seconds")
    if stats is not None:
        extra = (f", {stats['iterations']} iterations"
                 if stats["kernel"] != "mega" else "")
        if stats["engine"] == "grid":
            extra += f", grid build {stats['grid_seconds']:.3f} s"
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
    # --step-size and --env-samples only steer the ray-marching
    # integrators, which are not ported; multiscatter ignores them, as in
    # gvr_tpu
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
                    "to 24576")
    pr.add_argument("--stats", action="store_true",
                    help="print the engine and kernel, paths, bounce "
                    "evaluations, Mpaths/s and the wavefront iterations")
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
