#!/usr/bin/env python3
"""A/B of the CUDA kernels of several checkouts on one card.

    python scripts/ab_kernels.py TREE [TREE ...] [--only k1,k2,k7,big]
                                 [--out FILE]

Each TREE is a directory that holds a ``gvr_tpu_torch`` package: a
checkout of this repository (for example an older commit unpacked with
``git archive``) or a copy of the package with an edited kernel.  One
worker process a tree, in turns: the trees in order, then in reverse
(A B B A for two).  Each worker builds its tree's kernels and times them
(CUDA events, mean of several launches after a warm-up) on inputs made
from fixed seeds, so every tree gets the same inputs.  Sections:
- k1: K1 on the headline's chunk 9 (random_gaussian_scene(250, 0), 1024^2
  tile order, 65,536 pixels through the medium) at spp 4 and 64, its
  phase split where the tree's ``mega_call`` takes ``phases`` (a second,
  instrumented launch), its blocks resident per SM where the tree has
  ``resident_blocks``, the headline render (1024^2 spp 64, host clock,
  two renders after a warm-up), and the RR-tail case of the card tests
  (16 Gaussians, seed 9, orthographic camera, 8^2 spp 4, max_bounces 10,
  RR from bounce 1, the tail cap from bounce 3);
- k2: K2 on chip_smoke phase 3's 65,536 random rays at N = 250, finisher
  off and on;
- k7: K6 and K7 at one grid iteration's shapes (chip_smoke phase 10: the
  10k scene's grid, 32,768 camera rays of tile-order chunk 4 of 512^2);
- big: K4 and K5 on chip_smoke phases 12 and 13's rays of the 10k scene
  and on the S_CAP_MAX fallback scene's rays, and (first turn) the 10k
  scene at 256^2 spp 16 with engine dense.
The main process prints each worker's times and compares each tree's
outputs with the first tree's: K1's evaluation counts pixel for pixel and
its radiance at this checkout's ``testing.CHUNK_BARS`` (the order of its
sums changes from run to run), every other output bit for bit; ``--out``
also writes them as JSON.  A tree whose ``kernels/pathtrace_big`` has no
``chunk_boxes`` is called without boxes.

Needs a CUDA card; imports neither JAX nor the JAX package.
"""

import argparse
import inspect
import json
import math
import os
import subprocess
import sys
import tempfile
import time

SECTIONS = ("k1", "k2", "k7", "big")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _timed(fn, reps):
    import torch
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


def _k1(dev, res, tensors):
    import torch

    from gvr_tpu_torch.cameras import OrthographicCamera, PinholeCamera
    from gvr_tpu_torch.config import RenderConfig
    from gvr_tpu_torch.integrators.multiscatter import (render_multiscatter,
                                                        tile_order)
    from gvr_tpu_torch.kernels import megatrace, pathtrace
    from gvr_tpu_torch.scene.generators import random_gaussian_scene
    from gvr_tpu_torch.scene.scene import parse_gmm

    def args_of(sc, cam, cfg, ids):
        return (megatrace.camera_vector(cam), pathtrace.pack_table(sc.medium),
                ids, cfg, sc.lights(), sc.env_color,
                isinstance(cam, PinholeCamera))

    tail = parse_gmm(random_gaussian_scene(16, seed=9, diameter=(0.3, 0.8),
                                           density=(1.0, 3.0)), device=dev)
    cfg = RenderConfig(width=8, height=8, spp=4, max_bounces=10,
                       min_scatter=1, rr_tail_after=3, rr_cap_tail=0.4)
    rad, count = megatrace.mega_call(*args_of(
        tail, OrthographicCamera.create([0, 1, 6], [0, 1, 0], device=dev),
        cfg, torch.arange(64, dtype=torch.int32, device=dev)))
    tensors["K1 ortho RR tail"] = (rad.cpu(), count.cpu(), cfg.spp)
    sc = parse_gmm(random_gaussian_scene(250, seed=0), device=dev)
    cam = PinholeCamera.create([0, 1, 6], [0, 1, 0], math.radians(45.0),
                               device=dev)
    chunk = torch.from_numpy(tile_order(1024, 1024)[9 * 65536:10 * 65536]
                             ).to(dev)
    takes_phases = "phases" in inspect.signature(
        megatrace.mega_call).parameters
    for spp, reps in ((4, 10), (64, 4)):
        cfg = RenderConfig(width=1024, height=1024, spp=spp)
        args = args_of(sc, cam, cfg, chunk)
        ms, (rad, count) = _timed(lambda: megatrace.mega_call(*args), reps)
        res["times"][f"k1_spp{spp}_ms"] = ms
        tensors[f"K1 chunk 9 spp {spp}"] = (rad.cpu(), count.cpu(), spp)
        if takes_phases:
            ph = torch.zeros((4, 3), dtype=torch.int64, device=dev)
            megatrace.mega_call(*args, phases=ph)
            torch.cuda.synchronize()
            res[f"k1_spp{spp}_phases"] = megatrace.phase_split(ph)
            res[f"k1_spp{spp}_phase_counters"] = ph.cpu().tolist()
    if hasattr(megatrace, "resident_blocks"):
        res["k1_resident"] = list(megatrace.resident_blocks(dev))
    cfg = RenderConfig(width=1024, height=1024, spp=64)
    secs = []
    for _ in range(3):
        st = {}
        render_multiscatter(sc, cam, cfg, device=dev, stats=st)
        secs.append(st["seconds"])
    res["times"]["headline_seconds"] = secs[1:]
    res["headline_mpaths_s"] = [1024 * 1024 * 64 / s / 1e6 for s in secs[1:]]


def _k2(dev, res, tensors):
    import numpy as np
    import torch

    from gvr_tpu_torch.kernels import pathtrace
    from gvr_tpu_torch.scene.generators import random_gaussian_scene
    from gvr_tpu_torch.scene.scene import parse_gmm

    sc = parse_gmm(random_gaussian_scene(250, seed=0), device=dev)
    r = np.random.default_rng(1)
    o = r.uniform(-1.5, 1.5, (65536, 3)) + [0.0, 1.0, 1.5]
    d = r.normal(size=(65536, 3))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    xi = r.uniform(size=(65536, 5))
    o, d, xi = (torch.tensor(a, dtype=torch.float32, device=dev)
                for a in (o, d, xi))
    table = pathtrace.pack_table(sc.medium)
    for fin in (False, True):
        ms, out = _timed(lambda: pathtrace.bounce_step(
            table, o, d, xi, sc.lights(), sc.env_color, 12, fin), 10)
        res["times"][f"k2_finisher{int(fin)}_ms"] = ms
        for k, t in enumerate(out):
            tensors[f"K2 finisher {fin} output {k}"] = t.cpu()


def _k7(dev, res, tensors):
    import numpy as np
    import torch

    from gvr_tpu_torch.accel.grid import build_grid
    from gvr_tpu_torch.cameras import PinholeCamera
    from gvr_tpu_torch.integrators import gridscatter
    from gvr_tpu_torch.integrators.multiscatter import tile_order
    from gvr_tpu_torch.kernels import gridtrace
    from gvr_tpu_torch.scene.generators import random_gaussian_scene
    from gvr_tpu_torch.scene.scene import parse_gmm

    sc = parse_gmm(random_gaussian_scene(10_000, seed=0), device=dev)
    grid = build_grid(sc.medium)
    cam = PinholeCamera.create([0, 1, 6], [0, 1, 0], math.radians(45.0),
                               device=dev)
    px = torch.from_numpy(tile_order(512, 512)[4 * 32768:5 * 32768]).to(dev)
    uv = torch.stack([(px % 512 + 0.5) / 512, (px // 512 + 0.5) / 512],
                     dim=-1).float()
    o, d = cam.sample_ray(uv)
    u = torch.tensor(np.random.default_rng(10).uniform(size=32768),
                     dtype=torch.float32, device=dev)
    tau, cells, t_in, t_out = gridscatter.grid_tau_crossings(grid, o, d)
    tensors["K6 tau"] = tau.cpu()
    _, _, cell_c, tin_c, tout_c, resid = gridscatter.critical_crossing(
        grid, tau, cells, t_in, t_out, u)
    tmax = torch.full((32768,), 1e8, device=dev)
    ms6, _ = _timed(lambda: gridtrace.span_tau_pass(grid, o, d, tmax,
                                                    cells), 20)
    args = (grid, o, d, tin_c, tout_c, resid, cell_c, 6)
    ms7, (t_sc, albedo) = _timed(lambda: gridtrace.solve_pass(*args), 20)
    res["times"].update(k6_ms=ms6, k7_ms=ms7)
    tensors["K7 t_sc"] = t_sc.cpu()
    tensors["K7 albedo"] = albedo.cpu()


def _big(dev, res, tensors, render):
    import numpy as np
    import torch

    from gvr_tpu_torch import testing
    from gvr_tpu_torch.cameras import PinholeCamera
    from gvr_tpu_torch.config import RenderConfig
    from gvr_tpu_torch.integrators.multiscatter import (render_multiscatter,
                                                        tile_order)
    from gvr_tpu_torch.kernels import pathtrace_big as pb
    from gvr_tpu_torch.ops.sampling import dir_from_xi
    from gvr_tpu_torch.scene.generators import random_gaussian_scene
    from gvr_tpu_torch.scene.scene import parse_gmm

    boxes_of = getattr(pb, "chunk_boxes", None)

    def kernels(table, boxes):
        kw = {} if boxes is None else {"boxes": boxes}
        k4 = lambda o, d, xi, lights: pb.big_stage1(table, o, d, xi, lights,
                                                    **kw)
        k5 = lambda s1, env: (pb.big_nee(table, s1, env) if boxes is None
                              else pb.big_nee(table, s1, env, boxes))
        return k4, k5

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
    for name, (sc, o, d, xi) in cases.items():
        table = pb.pack_rows(sc.medium)
        k4, k5 = kernels(table, None if boxes_of is None
                         else boxes_of(sc.medium))
        k4_ms, s1 = _timed(lambda: k4(o, d, xi, sc.lights()), 10)
        k5_ms, li = _timed(lambda: k5(s1, sc.env_color), 10)
        res["times"][name] = {"k4_ms": k4_ms, "k5_ms": k5_ms}
        tensors[name + " K4"] = s1.cpu()
        tensors[name + " K5"] = li.cpu()
    if render:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        img = render_multiscatter(sc10k, cam, RenderConfig(
            width=256, height=256, spp=16, engine="dense"), device=dev)
        res["render_256_seconds"] = time.perf_counter() - t0
        tensors["big render 256^2 spp 16"] = torch.from_numpy(img)


def _worker(tree: str, out: str, render: bool, only) -> None:
    sys.path.insert(0, os.path.abspath(tree))
    import torch

    from gvr_tpu_torch.kernels import _build

    if not torch.cuda.is_available():
        raise SystemExit("ab_kernels: needs a CUDA card")
    dev = torch.device("cuda", 0)
    build = _build.build()
    _build.library()
    res = {"tree": tree, "build_seconds": build["seconds"],
           "device": torch.cuda.get_device_name(0), "times": {}}
    tensors = {}
    for name in only:
        if name == "big":
            _big(dev, res, tensors, render)
        else:
            {"k1": _k1, "k2": _k2, "k7": _k7}[name](dev, res, tensors)
    torch.save({"res": res, "tensors": tensors}, out)


def _compare(tensors, ref):
    """{output: True/False (None where the first tree lacks it)}: K1's
    evaluation counts and every other output bit for bit, K1's radiance at
    CHUNK_BARS (with its measures)."""
    import torch

    from gvr_tpu_torch.testing import chunk_agreement
    eq = {}
    for name, t in tensors.items():
        if name not in ref:
            eq[name] = None
        elif name.startswith("K1"):
            (rad, count, spp), (rad_r, count_r, _) = t, ref[name]
            eq[name + " counts"] = bool(torch.equal(count, count_r))
            got = chunk_agreement((rad, count), (rad_r, count_r), spp)
            eq[name + " radiance"] = got.pop("ok")
            eq[name + " measures"] = got
        else:
            eq[name] = bool(torch.equal(t, ref[name]))
    return eq


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("trees", nargs="+")
    ap.add_argument("--only", default=",".join(SECTIONS),
                    help="comma-separated sections of " + ", ".join(SECTIONS))
    ap.add_argument("--out", help="write the summary here as JSON")
    ap.add_argument("--worker", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("--save", help=argparse.SUPPRESS)
    ap.add_argument("--render", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    only = [s for s in args.only.split(",") if s]
    if any(s not in SECTIONS for s in only):
        ap.error(f"--only takes {', '.join(SECTIONS)}")
    if args.worker:
        return _worker(args.trees[0], args.save, args.render, only)

    sys.path.insert(0, ROOT)          # this checkout's testing module
    import torch
    order = list(args.trees) + list(reversed(args.trees))
    runs, first = [], {}
    with tempfile.TemporaryDirectory() as tmp:
        for k, tree in enumerate(order):
            save = os.path.join(tmp, f"{k}.pt")
            cmd = [sys.executable, os.path.abspath(__file__), "--worker",
                   tree, "--save", save, "--only", ",".join(only)]
            if tree not in first:
                cmd.append("--render")
            subprocess.run(cmd, check=True)
            run = torch.load(save)
            first.setdefault(tree, run["tensors"])
            runs.append(run["res"])
            print(json.dumps(run["res"]), flush=True)
    ref = first[args.trees[0]]
    equal = {tree: _compare(tensors, ref) for tree, tensors in first.items()}
    for tree, eq in equal.items():
        print(f"{tree}: outputs against {args.trees[0]}'s (K1 counts and "
              f"every other output bit for bit, K1 radiance at CHUNK_BARS): "
              f"{json.dumps(eq)}", flush=True)
        for name, t in first[tree].items():
            want = ref.get(name)
            if name.startswith("K1"):          # (radiance, counts, spp)
                name, t, want = name + " counts", t[1], want and want[1]
            if eq.get(name) is False:
                diff = (t.double() - want.double()).abs()
                print(f"  {name}: {int((diff > 0).sum())} of {diff.numel()} "
                      f"values differ, max |diff| {diff.max().item():.3e}",
                      flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"runs": runs, "equal": equal}, f, indent=1)


if __name__ == "__main__":
    sys.exit(main())
