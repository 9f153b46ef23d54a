"""Mpaths/s series over the reference's scaling fixtures (50 -> 20k
Gaussians) and a generated 40k scene, one JSON row a scene.

    python -m gvr_tpu_torch.bench_series [--size 512] [--spp 8]
        [--fixtures DIR] [--device cuda]

The port of ``scripts/bench_series.py``, with its rows and JSON: each
scene's rays per path (``utils.profiling.path_statistics``), the seconds
of a warm ``render_multiscatter`` (after one render of the same
configuration), Mrays/s = size^2 x spp x rays per path / seconds, and the
engine, with the grid's side, slices and s_cap where the grid renders.
The fixtures (``SCENES``) are read from ``--fixtures``, the reference's
``scenes/gaussians`` directory, where given; the last row is
``random_gaussian_scene(40_000, seed=12)``, the reference generator's
distribution (``BENCH_40K=0`` leaves it out).  A scene that fails prints
a ``scene_failed`` row and the series goes on.  No gate: the series is a
record, not a benchmark.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import time

import numpy as np

SCENES = ["50_random.txt", "250_random.txt", "1000_random.txt",
          "2500_random_small.txt", "5000_random.txt", "10k_random.txt",
          "20k_bias.txt"]


def bench_row(name: str, scene, camera, cfg, device="cuda") -> dict:
    """One row of the series: ``scene`` rendered by ``render_multiscatter``
    with ``cfg`` on ``device``, warm."""
    from gvr_tpu_torch.accel.grid import H
    from gvr_tpu_torch.integrators.gridscatter import grid_for
    from gvr_tpu_torch.integrators.multiscatter import render_multiscatter
    from gvr_tpu_torch.utils.profiling import path_statistics

    rpp = path_statistics(scene, camera, cfg, device=device)["rays_per_path"]
    warm = {}              # the path the render takes (``render_path``)
    render_multiscatter(scene, camera, cfg, device=device, stats=warm)
    t0 = time.time()
    img = render_multiscatter(scene, camera, cfg, device=device)
    dt = time.time() - t0
    if not np.isfinite(img).all():
        raise FloatingPointError(f"{name}: the image is not finite")
    mrays = cfg.width * cfg.height * cfg.spp * rpp / dt / 1e6
    row = {"scene": name, "gaussians": scene.medium.n,
           "rays_per_path": round(rpp, 2), "seconds": round(dt, 2),
           "mrays_per_sec": round(mrays, 3)}
    row.update(engine=warm["engine"])
    if warm["kernel"] == "grid":
        g = grid_for(scene.medium)
        row.update(grid_side=g.side[0], slices=-(-g.n_entries // H),
                   s_cap=g.s_cap)
    return row


def main(argv=None) -> list:
    from gvr_tpu_torch.cameras import PinholeCamera
    from gvr_tpu_torch.config import RenderConfig
    from gvr_tpu_torch.scene.generators import random_gaussian_scene
    from gvr_tpu_torch.scene.scene import load_gmm, parse_gmm

    ap = argparse.ArgumentParser(prog="gvr_tpu_torch.bench_series")
    ap.add_argument("--size", type=int, default=512)
    ap.add_argument("--spp", type=int, default=8)
    ap.add_argument("--fixtures", default=None, metavar="DIR",
                    help="the reference's scenes/gaussians directory")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    camera = PinholeCamera.create([0, 1, 6], [0, 1, 0], 0.25 * math.pi,
                                  device=args.device)
    cfg = RenderConfig(width=args.size, height=args.size, spp=args.spp)

    def scene_iter():
        for name in SCENES if args.fixtures else ():
            path = os.path.join(args.fixtures, name)
            if os.path.exists(path):
                yield name, lambda p=path: load_gmm(p, device=args.device)
        # one step beyond the reference's largest fixture, whose
        # 40k_random.txt is lost: the same generator's distribution, last
        # so the fixtures' rows land even if it fails
        if int(os.environ.get("BENCH_40K", "1")):
            yield "40k_random_generated", lambda: parse_gmm(
                random_gaussian_scene(40_000, seed=12), device=args.device)

    results = []
    for name, load in scene_iter():
        try:
            row = bench_row(name, load(), camera, cfg, args.device)
        except Exception as e:
            # one scene's failure must not lose the rows after it
            print(json.dumps({"scene_failed": name,
                              "error": f"{type(e).__name__}: {e}"[:300]}),
                  flush=True)
            continue
        results.append(row)
        print(json.dumps(row), flush=True)
    print(json.dumps({"series": results}))
    return results


if __name__ == "__main__":
    main()
