"""Command-line entry point: render a scene, animate a turntable, or fit
Gaussians to an image.

Counterpart of ``gvr_tpu/cli.py``, with the same flags and defaults
(512x512, camera at (0,1,6) looking at (0,1,0), FOV 45 degrees; render:
256 spp, step 0.01, 20 environment samples; animate: the ray marcher, 120
frames at 30 fps, radius 6, spp 16; fit: 1000 iterations, lr 1e-2,
4,096-pixel batches, 4 bounces, snapshots at 16 spp, the final render at
1024) apart from the TPU-only ``--pallas``, and with ``--device`` (default
cuda):

    python -m gvr_tpu_torch.cli render scene.txt -o out.ppm \
        [--integrator multiscatter|singlescatter|raymarch|pureraymarch|hitmask]
    python -m gvr_tpu_torch.cli animate scene.txt -o anim.gif \
        [--integrator raymarch|multiscatter]
    python -m gvr_tpu_torch.cli fit init.txt --target target.ppm \
        -o fit_output [--iters 1000] [--snapshots]
    torchrun --nproc-per-node G -m gvr_tpu_torch.cli render|fit ...

A scene is GMM text, SMM (sphere) text or a voxel .npz.  render routes by
medium as the JAX package does: raymarch on spheres takes the sphere
marcher, and a voxel grid renders with the pure marcher only (raymarch
goes there too; the other integrators are refused).  Under torchrun
(WORLD_SIZE in the environment) each rank joins the job's process group
on its own card (``parallel.sharding.init_process_group``) and runs the
command: the multiscatter render and the fit are data parallel over the
ranks, and only rank 0 writes files.  ``--trace DIR`` writes a
torch.profiler Chrome trace of a multiscatter render
(``utils.profiling.device_trace``).  ``main`` returns the command's
result (for render the ``--stats`` summary, a ``RenderStats``; for
animate the frames, seconds, and on the writing rank the GIF path, its
bytes and the GIF backend; for fit the iterations, seconds, logged
(iteration, loss) pairs, written paths and the fitted scene's packed
parameters).
"""

from __future__ import annotations

import argparse
import math
import os
import re
import time

import torch.distributed as dist

INTEGRATORS = ("multiscatter", "singlescatter", "raymarch", "pureraymarch",
               "hitmask")


# JAX's refusal of a voxel scene's other integrators (gvr_tpu/cli.py:59-66)
VOXEL_REFUSAL = ("voxel media render with the medium-agnostic marcher "
                 "only; use --integrator pureraymarch (or raymarch)")


def renderer(integrator: str, scene=None):
    """The render function (scene, camera, cfg, device=, stats=) of one of
    INTEGRATORS for ``scene``'s medium: raymarch takes the sphere marcher
    on a sphere scene, as in the JAX package."""
    from gvr_tpu_torch.integrators.freeflight import render_single_scatter
    from gvr_tpu_torch.integrators.multiscatter import render_multiscatter
    from gvr_tpu_torch.integrators.raymarch import (
        render_pure_raymarch, render_raymarch_gaussians,
        render_raymarch_spheres)
    from gvr_tpu_torch.integrators.test_hit import render_hit_mask
    from gvr_tpu_torch.scene.spheres import SphereMixture
    spheres = scene is not None and isinstance(scene.medium, SphereMixture)
    return {"multiscatter": render_multiscatter,
            "singlescatter": render_single_scatter,
            "raymarch": (render_raymarch_spheres if spheres
                         else render_raymarch_gaussians),
            "pureraymarch": render_pure_raymarch,
            "hitmask": render_hit_mask}[integrator]


def make_camera(args, device):
    from gvr_tpu_torch.cameras import OrthographicCamera, PinholeCamera
    if args.camera == "pinhole":
        return PinholeCamera.create(args.pos, args.lookat,
                                    math.radians(args.fov), device=device)
    return OrthographicCamera.create(args.pos, args.lookat, device=device)


def _lead() -> bool:
    """Whether this process writes files: rank 0 of a distributed job, or
    the one process."""
    return not dist.is_initialized() or dist.get_rank() == 0


def cmd_render(args):
    from gvr_tpu_torch.config import RenderConfig, Solver
    from gvr_tpu_torch.io.ppm import write_ppm
    from gvr_tpu_torch.scene.scene import load_scene
    from gvr_tpu_torch.utils.profiling import RenderStats, device_trace

    cfg = RenderConfig(width=args.width, height=args.height, spp=args.spp,
                       step_size=args.step_size,
                       env_samples=args.env_samples,
                       solver=Solver(args.solver), seed=args.seed,
                       engine=args.engine)
    from gvr_tpu_torch.scene.voxels import VoxelGrid

    scene = load_scene(args.scene, device=args.device)
    if isinstance(scene.medium, VoxelGrid):
        # a voxel grid has no analytic transmittance: the pure marcher
        if args.integrator not in ("raymarch", "pureraymarch"):
            raise SystemExit(VOXEL_REFUSAL)
        args.integrator = "pureraymarch"
    camera = make_camera(args, args.device)
    lead = _lead()
    stats = RenderStats() if args.stats or args.trace else None
    t0 = time.time()
    multi = args.integrator == "multiscatter"
    kw = {"progress": args.verbose and lead} if multi else {}
    with device_trace(args.trace if multi and lead else None):
        img = renderer(args.integrator, scene)(scene, camera, cfg,
                                               device=args.device,
                                               stats=stats, **kw)
    print(f"Render time: {time.time() - t0:.3f} seconds")
    if args.trace and not multi:
        print("[render] note: --trace is only instrumented for "
              "--integrator multiscatter")
    if args.stats and not multi:
        extra = "".join(f", {k} {stats[k]}" for k in (
            "paths", "k3_launches", "n_steps", "steps", "shadow_steps",
            "chunks") if k in stats)
        print(f"[render] {args.integrator}: {stats['seconds']:.3f} s on "
              f"{stats['device']}, chunk {stats['chunk']}{extra}")
    elif args.stats:
        extra = (f", {stats['iterations']} iterations"
                 if stats["kernel"] != "mega" else "")
        if stats["engine"] == "grid":
            extra += f", grid build {stats['grid_seconds']:.3f} s"
        extra += f", chunk {stats['chunk']}"
        if stats["shards"] > 1:
            extra += (f", {stats['shards']} shards, assembly "
                      f"{stats['assemble_seconds']:.3f} s")
        print(f"[render] engine {stats['engine']} ({stats['kernel']} "
              f"kernel): {stats['paths']} paths, "
              f"{stats['bounce_evals']} bounce evaluations in "
              f"{stats['seconds']:.3f} s on {stats['device']}: "
              f"{stats['paths'] / stats['seconds'] / 1e6:.3f} Mpaths/s{extra}")
        print(stats.report())
    if lead:
        write_ppm(args.output, img)
        print(f"wrote {args.output}")
    return stats


def cmd_animate(args):
    """Render the turntable GIF (io/turntable): the reference's orbit
    camera, so --camera, --pos and --fov are ignored."""
    from gvr_tpu_torch.config import RenderConfig
    from gvr_tpu_torch.io import gif
    from gvr_tpu_torch.io.turntable import render_turntable
    from gvr_tpu_torch.scene.scene import load_scene

    if (args.camera, tuple(args.pos), args.fov) != \
            ("pinhole", (0.0, 1.0, 6.0), 45.0):
        print("[animate] note: --camera/--pos/--fov are ignored; the "
              "turntable uses the reference orbit camera "
              "(orthographic, tests/main.cpp:95-103)")
    scene = load_scene(args.scene, device=args.device)
    cfg = RenderConfig(width=args.width, height=args.height, spp=args.spp,
                       step_size=args.step_size,
                       env_samples=args.env_samples, seed=args.seed)
    lead = _lead()
    t0 = time.time()
    render_turntable(scene, args.output if lead else None, cfg,
                     lookat=tuple(args.lookat), radius=args.radius,
                     num_frames=args.frames, fps=args.fps,
                     integrator=args.integrator, device=args.device)
    seconds = time.time() - t0
    if not lead:
        return dict(frames=args.frames, seconds=seconds)
    print(f"GIF saved ({seconds:.1f}s): {args.output}")
    return dict(frames=args.frames, seconds=seconds, path=args.output,
                bytes=os.path.getsize(args.output),
                backend=gif.last_backend)


def cmd_fit(args):
    """Fit the scene's Gaussians to ``--target`` (inverse/fit), writing a
    snapshot render every ``--save-every`` iterations with
    ``--snapshots``, ckpt.npz every 100 and the final render, all into
    ``-o``; the renders through ``render_multiscatter`` on the detached
    parameters.  In a distributed job every rank fits and renders, and
    rank 0 writes."""
    import torch

    from gvr_tpu_torch.config import FitConfig, RenderConfig
    from gvr_tpu_torch.integrators.multiscatter import render_multiscatter
    from gvr_tpu_torch.inverse.fit import fit_gaussians
    from gvr_tpu_torch.io.ppm import read_ppm, write_ppm
    from gvr_tpu_torch.scene.scene import load_scene

    scene = load_scene(args.scene, device=args.device)
    camera = make_camera(args, args.device)
    target = read_ppm(args.target)
    h, w = target.shape[:2]
    cfg = FitConfig(max_iters=args.iters, lr=args.lr,
                    save_every=args.save_every, out_dir=args.output,
                    seed=args.seed)
    lead = _lead()
    if lead and (args.width, args.height) != (512, 512):
        print("[fit] note: --width/--height are ignored; the fit "
              f"resolution comes from the target image ({w}x{h})")
    losses, paths = [], []

    def log(msg):
        print(msg, flush=True)
        m = re.match(r"\[fit\] iter (\d+) loss (\S+)", msg)
        if m:
            losses.append((int(m.group(1)), float(m.group(2))))

    def render(sc, spp, path):
        with torch.no_grad():
            img = render_multiscatter(sc, camera,
                                      RenderConfig(width=w, height=h,
                                                   spp=spp),
                                      device=args.device)
        if lead:
            write_ppm(path, img)
        paths.append(path)

    def snapshot(it, sc):
        render(sc, args.spp, f"{args.output}/iter_{it:04d}.ppm")

    t0 = time.time()
    fitted = fit_gaussians(scene, camera, target, cfg,
                           batch_pixels=args.batch_pixels,
                           n_bounces=args.bounces, log=log,
                           save_snapshot=snapshot if args.snapshots
                           else None)
    seconds = time.time() - t0
    print(f"Inverse optimization time: {seconds:.1f} seconds")
    # the final render at high spp (inverse_integrator.h:230-233)
    render(fitted, args.final_spp, f"{args.output}/final.ppm")
    print(f"wrote {args.output}/final.ppm")
    return dict(iterations=args.iters, seconds=seconds, losses=losses,
                paths=paths,
                params=fitted.medium.pack_parameters().cpu().numpy())


def _add_common(p):
    """The scene, size, camera and seed flags of every command."""
    p.add_argument("scene", help="scene file: GMM or SMM text, or a voxel "
                   ".npz")
    p.add_argument("--width", type=int, default=512)
    p.add_argument("--height", type=int, default=512)
    p.add_argument("--camera", choices=["pinhole", "orthographic"],
                   default="pinhole")
    p.add_argument("--pos", type=float, nargs=3, default=[0.0, 1.0, 6.0])
    p.add_argument("--lookat", type=float, nargs=3,
                   default=[0.0, 1.0, 0.0])
    p.add_argument("--fov", type=float, default=45.0, help="degrees")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda",
                   help="torch device to run on (cuda, cuda:N or cpu); "
                   "under torchrun each rank takes card LOCAL_RANK % cards")


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="gvr_tpu_torch",
        description="Gaussian volume renderer (PyTorch/CUDA)")
    sub = ap.add_subparsers(dest="cmd", required=True)
    pr = sub.add_parser("render", help="forward render to PPM")
    _add_common(pr)
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
                    help="write a torch.profiler Chrome trace of the "
                    "multiscatter render to DIR/trace.json")
    pr.add_argument("-v", "--verbose", action="store_true")
    pr.set_defaults(fn=cmd_render)

    pa = sub.add_parser("animate", help="turntable GIF")
    _add_common(pa)
    pa.add_argument("-o", "--output", default="animation.gif")
    pa.add_argument("--integrator", default="raymarch",
                    choices=["raymarch", "multiscatter"])
    pa.add_argument("--frames", type=int, default=120)
    pa.add_argument("--fps", type=float, default=30.0)
    pa.add_argument("--radius", type=float, default=6.0)
    pa.add_argument("--spp", type=int, default=16)
    pa.add_argument("--step-size", dest="step_size", type=float,
                    default=0.01)
    pa.add_argument("--env-samples", dest="env_samples", type=int,
                    default=20)
    pa.set_defaults(fn=cmd_animate)

    pf = sub.add_parser("fit", help="fit Gaussians to a target image")
    _add_common(pf)
    pf.add_argument("--target", required=True, help="target PPM image")
    pf.add_argument("-o", "--output", default="./fit_output")
    pf.add_argument("--iters", type=int, default=1000)
    pf.add_argument("--lr", type=float, default=1e-2)
    pf.add_argument("--save-every", dest="save_every", type=int, default=25)
    pf.add_argument("--batch-pixels", dest="batch_pixels", type=int,
                    default=4096)
    pf.add_argument("--bounces", type=int, default=4)
    pf.add_argument("--spp", type=int, default=16,
                    help="samples per pixel of the snapshot renders")
    pf.add_argument("--final-spp", dest="final_spp", type=int,
                    default=1024)
    pf.add_argument("--snapshots", action="store_true")
    pf.set_defaults(fn=cmd_fit)
    args = ap.parse_args(argv)
    if "WORLD_SIZE" not in os.environ or dist.is_initialized():
        return args.fn(args)
    # under torchrun: join the job on this rank's card for the command
    from gvr_tpu_torch.parallel.sharding import init_process_group
    args.device = str(init_process_group(args.device))
    print(f"[gvr] rank {dist.get_rank()}/{dist.get_world_size()} on "
          f"{args.device} ({dist.get_backend()})", flush=True)
    try:
        return args.fn(args)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
