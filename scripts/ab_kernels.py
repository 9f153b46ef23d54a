#!/usr/bin/env python3
"""A/B of the CUDA kernels of several checkouts on one card.

    python scripts/ab_kernels.py TREE [TREE ...]
        [--only k1,k2,k3,grid,big,renders] [--out FILE]

Each TREE is a directory that holds a ``gvr_tpu_torch`` package: a
checkout of this repository (for example an older commit unpacked with
``git archive``) or a copy of the package with an edited kernel.  One
worker process a tree, in turns: the trees in order, then in reverse
(A B B A for two).  Each worker builds its tree's kernels and times them
on inputs made from fixed seeds, so every tree gets the same inputs: each
kernel's device time by torch.profiler and its call's dispatch (CUDA
events less device time; ``gvr_tpu_torch/kernels/timing.py`` of this
checkout, loaded by path, so older trees are timed alike).  Sections:
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
- k3: K3 as a wavefront iteration launches it, on 65,536 lanes: one
  ``wave_uniforms`` launch where the tree has it, else the two
  ``planes_uniforms`` launches (the jitter pair, the bounce's nine draws)
  it replaces; the [2 + 9, B] planes;
- grid: K6 and K7 at one grid iteration's shapes, built as chip_smoke
  phase 10 builds them (the 10k scene's grid, 32,768 camera rays of
  tile-order chunk 4 of 512^2 and their 32,768 NEE rays; u and the NEE
  draws from seed 10);
- big: K4 and K5 on chip_smoke phases 12 and 13's rays of the 10k scene
  (the 65,536 lanes after one bounce also cut to their first 24,576 and
  4,096, the live lanes of a typical and of a late iteration) and on the
  S_CAP_MAX fallback scene's rays;
- renders (first turn of each tree): the 10k scene at 512^2 spp 16 with
  engine auto (the grid) and with engine dense (the big-N engine), the
  images and render seconds.
The main process prints each worker's times and compares each tree's
outputs with the first tree's: K1's evaluation counts pixel for pixel and
its radiance at this checkout's ``testing.CHUNK_BARS`` (the order of its
sums changes from run to run), every other output bit for bit; ``--out``
also writes them as JSON.  A tree whose ``kernels/pathtrace_big`` has no
``chunk_boxes`` is called without boxes.

Needs a CUDA card; imports neither JAX nor the JAX package.
"""

import argparse
import importlib.util
import inspect
import json
import math
import os
import subprocess
import sys
import tempfile

SECTIONS = ("k1", "k2", "k3", "grid", "big", "renders")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _kernel_ms():
    """This checkout's timing.kernel_ms, loaded by path: the worker's
    ``gvr_tpu_torch`` is the tree's, which may predate it."""
    spec = importlib.util.spec_from_file_location(
        "_ab_timing", os.path.join(ROOT, "gvr_tpu_torch", "kernels",
                                   "timing.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.kernel_ms


def _timed(res, key, fn, kernel, reps, per_call=1):
    """fn's result; res['times'][key] gets the device ms of ``kernel`` a
    call, res['dispatch_us'][key] the call's dispatch, res['recorded'][key]
    the share of the launches the profiler recorded."""
    t, out = _kernel_ms()(fn, kernel, reps, per_call)
    res["times"][key] = t["ms"]
    res["dispatch_us"][key] = t["dispatch_us"]
    res["recorded"][key] = t["recorded"]
    return out


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
        rad, count = _timed(res, f"k1_spp{spp}_ms",
                            lambda: megatrace.mega_call(*args), "mega_kernel",
                            reps)
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
        out = _timed(res, f"k2_finisher{int(fin)}_ms",
                     lambda: pathtrace.bounce_step(
                         table, o, d, xi, sc.lights(), sc.env_color, 12,
                         fin), "bounce_kernel", 10)
        for k, t in enumerate(out):
            tensors[f"K2 finisher {fin} output {k}"] = t.cpu()


def _k3(dev, res, tensors):
    import numpy as np
    import torch

    from gvr_tpu_torch.kernels import rng

    r = np.random.default_rng(3)
    pid, smp, bnc = (torch.from_numpy(r.integers(0, hi, 65536)
                                      .astype(np.int32)).to(dev)
                     for hi in (2**31 - 1, 1 << 20, 64))
    if hasattr(rng, "wave_uniforms"):
        buf = torch.empty((11, 65536), dtype=torch.float32, device=dev)
        planes = _timed(res, "k3_ms", lambda: rng.wave_uniforms(
            pid, smp, bnc, 0, out=buf), "wave_uniforms_kernel", 50)
    else:
        planes = torch.cat(_timed(res, "k3_ms", lambda: (
            rng.planes_uniforms(pid, smp, rng.JITTER_TAG, 2, 0),
            rng.planes_uniforms(pid, smp, bnc, 9, 0)), "uniforms_kernel",
            50, per_call=2))
    tensors["K3 planes [2 + 9, 65536]"] = planes.cpu()


def _grid(dev, res, tensors):
    import numpy as np
    import torch

    from gvr_tpu_torch.accel.grid import build_grid, dda_crossings
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
    n = 32768
    px = torch.from_numpy(tile_order(512, 512)[4 * n:5 * n]).to(dev)
    uv = torch.stack([(px % 512 + 0.5) / 512, (px // 512 + 0.5) / 512],
                     dim=-1).float()
    o, d = cam.sample_ray(uv)
    xi = torch.tensor(np.random.default_rng(10).uniform(size=(n, 5)),
                      dtype=torch.float32, device=dev)
    # the kernels' inputs from the plain versions, the same in every tree
    cells, t_in, t_out = dda_crossings(grid, o, d)
    tau = gridtrace.span_tau_reference(grid, o, d, torch.full(
        (n,), 1e8, device=dev), cells)
    scattered, _, cell_c, tin_c, tout_c, resid = \
        gridscatter.critical_crossing(grid, tau, cells, t_in, t_out, xi[:, 0])
    args = (grid, o, d, tin_c, tout_c, resid, cell_c, 6)
    t_sc, albedo = _timed(res, "k7_ms", lambda: gridtrace.solve_pass(*args),
                          "grid_solve_kernel", 20)
    tensors["K7 t_sc"] = t_sc.cpu()
    tensors["K7 albedo"] = albedo.cpu()
    # K6 over the camera rays and their NEE rays, as chip_smoke phase 10
    t_sc = gridtrace.solve_reference(*args)[0]
    pos = o + torch.clamp(t_sc, min=0.0)[:, None] * d
    wi, tmax_n, _, _ = gridscatter._nee_select(sc, pos, xi[:, 1], xi[:, 2],
                                               xi[:, 3:5])
    o2, d2 = torch.cat([o, pos]), torch.cat([d, wi])
    tmax2 = torch.cat([torch.full((n,), 1e8, device=dev),
                       torch.where(scattered, tmax_n, 0.0)])
    cells2 = dda_crossings(grid, o2, d2, tmax2)[0]
    tensors["K6 tau"] = _timed(
        res, "k6_ms", lambda: gridtrace.span_tau_pass(grid, o2, d2, tmax2,
                                                      cells2),
        "span_tau_kernel", 20).cpu()


def _big(dev, res, tensors):
    import numpy as np
    import torch

    from gvr_tpu_torch import testing
    from gvr_tpu_torch.cameras import PinholeCamera
    from gvr_tpu_torch.integrators.multiscatter import tile_order
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
        "10k 24,576 lanes after one bounce": (
            sc10k, o13b[:24576], d13b[:24576].contiguous(), xi13[1, :24576]),
        "10k 4,096 lanes after one bounce": (
            sc10k, o13b[:4096], d13b[:4096].contiguous(), xi13[1, :4096]),
        "fallback rays": (sc_fb, *testing.big_rays(sc_fb.medium, 8192, 12,
                                                   dev)),
    }
    for name, (sc, o, d, xi) in cases.items():
        table = pb.pack_rows(sc.medium)
        k4, k5 = kernels(table, None if boxes_of is None
                         else boxes_of(sc.medium))
        s1 = _timed(res, name + " k4_ms", lambda: k4(o, d, xi, sc.lights()),
                    "big_stage1_kernel", 10)
        li = _timed(res, name + " k5_ms", lambda: k5(s1, sc.env_color),
                    "big_nee_kernel", 10)
        tensors[name + " K4"] = s1.cpu()
        tensors[name + " K5"] = li.cpu()


def _renders(dev, res, tensors):
    import torch

    from gvr_tpu_torch.cameras import PinholeCamera
    from gvr_tpu_torch.config import RenderConfig
    from gvr_tpu_torch.integrators.multiscatter import render_multiscatter
    from gvr_tpu_torch.scene.generators import random_gaussian_scene
    from gvr_tpu_torch.scene.scene import parse_gmm

    cam = PinholeCamera.create([0, 1, 6], [0, 1, 0], math.radians(45.0),
                               device=dev)
    sc = parse_gmm(random_gaussian_scene(10_000, seed=0), device=dev)
    for engine in ("auto", "dense"):
        st = {}
        img = render_multiscatter(sc, cam, RenderConfig(
            width=512, height=512, spp=16, engine=engine), device=dev,
            stats=st)
        res[f"render_512_{engine}"] = {k: st[k] for k in (
            "engine", "kernel", "seconds", "iterations")}
        tensors[f"render 512^2 spp 16 engine {engine} ({st['engine']})"] = \
            torch.from_numpy(img)


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
           "device": torch.cuda.get_device_name(0), "times": {},
           "dispatch_us": {}, "recorded": {}}
    tensors = {}
    sections = {"k1": _k1, "k2": _k2, "k3": _k3, "grid": _grid, "big": _big,
                "renders": _renders}
    for name in only:
        if name != "renders" or render:
            sections[name](dev, res, tensors)
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
