#!/usr/bin/env python3
"""A/B of the big-N kernels (K4, K5) of several checkouts on one card.

    python scripts/ab_big_kernels.py TREE [TREE ...] [--out FILE]

Each TREE is a directory that holds a ``gvr_tpu_torch`` package: a
checkout of this repository (for example an older commit unpacked with
``git archive``) or a copy of the package with an edited kernel.  One
worker process a tree, in turns: the trees in order, then in reverse
(A B B A for two).  Each worker builds its tree's kernels and times K4 and
K5 (CUDA events, mean of 10 launches after a warm-up) on the inputs of
chip_smoke.py phases 12 and 13, made from fixed seeds, so every tree gets
the same inputs:
- the 10k scene's phase-12 rays (8,192 camera rays and 8,192 rays from
  inside the medium, the scene's 3 lights);
- the 65,536 lanes of tile-order chunk 2 of the 512^2 image, as primary
  rays and after one bounce (moved by the plain version of K4);
- the S_CAP_MAX fallback scene's rays (random_gaussian_scene(8000, 0,
  diameter 2-4), 8,192 of each kind);
and, in its first turn, renders the 10k scene at 256^2 spp 16 with engine
dense.  The main process prints each worker's times, and whether each
tree's outputs (K4's rows, K5's Li, the image) equal the first tree's bit
for bit; ``--out`` also writes them as JSON.  A tree whose
``kernels/pathtrace_big`` has no ``chunk_boxes`` is called without boxes.

Needs a CUDA card; imports neither JAX nor the JAX package.
"""

import argparse
import json
import math
import os
import subprocess
import sys
import tempfile
import time


def _worker(tree: str, out: str, render: bool) -> None:
    sys.path.insert(0, os.path.abspath(tree))
    import numpy as np
    import torch

    from gvr_tpu_torch import testing
    from gvr_tpu_torch.cameras import PinholeCamera
    from gvr_tpu_torch.config import RenderConfig
    from gvr_tpu_torch.integrators.multiscatter import (render_multiscatter,
                                                        tile_order)
    from gvr_tpu_torch.kernels import _build
    from gvr_tpu_torch.kernels import pathtrace_big as pb
    from gvr_tpu_torch.ops.sampling import dir_from_xi
    from gvr_tpu_torch.scene.generators import random_gaussian_scene
    from gvr_tpu_torch.scene.scene import parse_gmm

    if not torch.cuda.is_available():
        raise SystemExit("ab_big_kernels: needs a CUDA card")
    dev = torch.device("cuda", 0)
    build = _build.build()
    _build.library()
    boxes_of = getattr(pb, "chunk_boxes", None)

    def kernels(table, boxes):
        kw = {} if boxes is None else {"boxes": boxes}
        k4 = lambda o, d, xi, lights: pb.big_stage1(table, o, d, xi, lights,
                                                    **kw)
        k5 = lambda s1, env: (pb.big_nee(table, s1, env) if boxes is None
                              else pb.big_nee(table, s1, env, boxes))
        return k4, k5

    def timed(fn, reps=10):
        fn()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            res = fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / reps, res

    cam = PinholeCamera.create([0, 1, 6], [0, 1, 0], math.radians(45.0),
                               device=dev)
    sc10k = parse_gmm(random_gaussian_scene(10_000, seed=0), device=dev)
    sc_fb = parse_gmm(random_gaussian_scene(8000, seed=0,
                                            diameter=(2.0, 4.0)), device=dev)
    lanes = torch.from_numpy(tile_order(512, 512)[2 * 65536:3 * 65536]).to(dev)
    uv = torch.stack([(lanes % 512 + 0.5) / 512,
                      (lanes // 512 + 0.5) / 512], dim=-1).float()
    o13, d13 = cam.sample_ray(uv)
    xi13 = torch.tensor(np.random.default_rng(13).uniform(size=(2, 65536, 5)),
                        dtype=torch.float32, device=dev)
    table10k = pb.pack_rows(sc10k.medium)
    s1 = pb.big_stage1_reference(table10k, o13, d13, xi13[0], sc10k.lights())
    moved = (s1[1] > 0.5)[:, None]
    o13b = torch.where(moved, o13 + s1[0][:, None] * d13, o13)
    d13b = torch.where(moved, dir_from_xi(xi13[1, :, 3:5]), d13)
    cases = {
        "10k phase-12 rays": (sc10k, *testing.big_rays(sc10k.medium, 8192,
                                                       12, dev)),
        "10k primary lanes": (sc10k, o13, d13, xi13[0]),
        "10k lanes after one bounce": (sc10k, o13b, d13b.contiguous(),
                                       xi13[1]),
        "fallback rays": (sc_fb, *testing.big_rays(sc_fb.medium, 8192, 12,
                                                   dev)),
    }
    res = {"tree": tree, "build_seconds": build["seconds"],
           "device": torch.cuda.get_device_name(0), "times": {}}
    tensors = {}
    for name, (sc, o, d, xi) in cases.items():
        table = pb.pack_rows(sc.medium)
        k4, k5 = kernels(table, None if boxes_of is None
                         else boxes_of(sc.medium))
        k4_ms, s1 = timed(lambda: k4(o, d, xi, sc.lights()))
        k5_ms, li = timed(lambda: k5(s1, sc.env_color))
        res["times"][name] = {"k4_ms": k4_ms, "k5_ms": k5_ms}
        tensors[name + " K4"] = s1.cpu()
        tensors[name + " K5"] = li.cpu()
    if render:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        img = render_multiscatter(sc10k, cam, RenderConfig(
            width=256, height=256, spp=16, engine="dense"), device=dev)
        res["render_256_seconds"] = time.perf_counter() - t0
        res["render_256_mean"] = float(img.mean())
        tensors["render 256^2 spp 16"] = torch.from_numpy(img)
    torch.save({"res": res, "tensors": tensors}, out)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("trees", nargs="+")
    ap.add_argument("--out", help="write the summary here as JSON")
    ap.add_argument("--worker", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("--save", help=argparse.SUPPRESS)
    ap.add_argument("--render", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.worker:
        return _worker(args.trees[0], args.save, args.render)

    import torch
    order = list(args.trees) + list(reversed(args.trees))
    runs, first = [], {}
    with tempfile.TemporaryDirectory() as tmp:
        for k, tree in enumerate(order):
            save = os.path.join(tmp, f"{k}.pt")
            cmd = [sys.executable, os.path.abspath(__file__), "--worker",
                   tree, "--save", save]
            if tree not in first:
                cmd.append("--render")
            subprocess.run(cmd, check=True)
            run = torch.load(save)
            first.setdefault(tree, run["tensors"])
            runs.append(run["res"])
            print(json.dumps(run["res"]), flush=True)
    ref = first[args.trees[0]]
    equal = {tree: {name: bool(torch.equal(t, ref[name])) if name in ref
                    else None for name, t in tensors.items()}
             for tree, tensors in first.items()}
    for tree, eq in equal.items():
        print(f"{tree}: outputs equal to {args.trees[0]}'s bit for bit: "
              f"{json.dumps(eq)}", flush=True)
        for name, t in first[tree].items():
            if eq[name] is False:
                diff = (t.double() - ref[name].double()).abs()
                print(f"  {name}: {int((diff > 0).sum())} of {diff.numel()} "
                      f"values differ, max |diff| {diff.max().item():.3e}",
                      flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"runs": runs, "equal": equal}, f, indent=1)


if __name__ == "__main__":
    sys.exit(main())
