#!/usr/bin/env python3
"""Drive the gvr_tpu_torch main path on one CUDA card and check its kernels.

    python3 chip_smoke.py

Builds the CUDA kernels from gvr_tpu_torch/csrc (nvcc, at first use), holds
each kernel against its plain PyTorch version on the card, times both at
the main path's shapes, and renders the headline configuration through the
CLI.  One line per phase; any failure raises, so the exit code is non-zero.

  0 card     nvidia-smi name and power limit, torch and nvcc versions
  1 build    nvcc seconds and ptxas register/spill lines
  2 K3 rng   kernel == plain (torch.equal), [9, 512, 128] draws, bounce
             array and the jitter tag
  3 K2 bounce  kernel vs plain, 250 Gaussians, 65,536 random rays,
             finisher off and on: the bars of testing.BOUNCE_BARS
  4 K1 mega  kernel vs plain at atol 1e-4 on 24 Gaussians 16^2 spp 9
             max_bounces 6, with 3 point lights and without, and on an ortho
             scene whose paths reach RR's tail cap; 250 Gaussians 64^2
             spp 16, image means within 1 % and per-pixel mean |diff| < 1e-3
  5 timing   each kernel and its plain version (CUDA events) at the main
             path's shapes: K3 [9, 65536], K2 65,536 rays at N = 250, K1 the
             headline's 65,536-pixel chunk through the medium at spp 4 and
             spp 64, there also held against the plain version (CHUNK_BARS)
  6 main     `gvr_tpu_torch.cli render` of random_gaussian_scene(250, 0) at
             1024^2 spp 64; image finite and not constant, megakernel
             launched, no plain version called

The last three lines: the nvidia-smi line, the kernels JSON, and the
result JSON.  Without a CUDA card, or without the package beside it, the
script exits non-zero before printing any result.
"""

import json
import math
import os
import subprocess
import sys
import tempfile
import time

KERNEL_SOURCE = "gvr_tpu_torch/csrc/kernels.cu"
MAIN_SIZE, MAIN_SPP = 1024, 64      # the headline render
RAYS = 65536                        # K2 rays, K3 draws, K1 chunk pixels
# The headline's 16 chunks are 64-row bands in tile order; band 9 (rows
# 576-639) crosses the medium and has the most bounce evaluations.
MEDIUM_CHUNK = 9
# K1 at the main path's shape, kernel vs plain per pixel (mean radiance).
# Rounding differences grow along a path, and a path whose scatter or RR
# test sits within them of its threshold takes the other branch and moves
# its pixel by its whole radiance / spp.  So the bars bound that radiance
# (max_path_diff), the share of pixels beyond testing.OFF_ATOL/OFF_RTOL
# (off_frac), the mean |diff| over the chunk and the evaluation total.  On
# the H100 chunk 9 measured max_path_diff 2.67 (spp 4) and 4.29 (spp 64),
# off_frac 1.2e-3 and 3.7e-3, mean_diff 2.3e-5 and 1.8e-5, evals_rel
# 8.7e-6 and 1.1e-6.
CHUNK_BARS = dict(max_path_diff=8.0, off_frac=1e-2, mean_diff=1e-4,
                  evals_rel=1e-4)


def log(phase, msg):
    print(f"[{phase}] {msg}", flush=True)


def cuda_ms(fn, reps, warmup=True):
    """(mean milliseconds of fn() over reps launches by CUDA events, the
    last launch's result)."""
    import torch
    if warmup:
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        out = fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps, out


def main():
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; "
                         "this script needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    run(torch.device("cuda", 0))


def run(dev):
    import numpy as np
    import torch

    from gvr_tpu_torch import cli, testing
    from gvr_tpu_torch.cameras import OrthographicCamera, PinholeCamera
    from gvr_tpu_torch.config import RenderConfig
    from gvr_tpu_torch.integrators.multiscatter import tile_order
    from gvr_tpu_torch.io.ppm import read_ppm
    from gvr_tpu_torch.kernels import _build, megatrace, pathtrace, rng
    from gvr_tpu_torch.scene.generators import random_gaussian_scene
    from gvr_tpu_torch.scene.scene import parse_gmm

    # ---- 0: the card ----
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    nvcc = subprocess.run([_build._nvcc(), "--version"], capture_output=True,
                          text=True, check=True).stdout.strip()
    log("0 card", f"{smi} | torch {torch.__version__} (CUDA "
        f"{torch.version.cuda}) | {nvcc.splitlines()[-1]} | "
        f"{torch.cuda.device_count()} device(s)")

    # ---- 1: build ----
    info = _build.build()
    _build.library()
    log("1 build", f"{'built' if info['built'] else 'found built'} "
        f"{os.path.relpath(info['path'])} in {info['seconds']:.1f} s")
    for line in info["log"].splitlines():
        if "registers" in line or "spill" in line:
            log("1 build", "ptxas: " + line.strip())

    # ---- 2: K3, the RNG kernel ----
    r = np.random.default_rng(0)
    pid = torch.from_numpy(r.integers(0, 2**31 - 1, (512, 128))
                           .astype(np.int32)).to(dev)
    smp = torch.from_numpy(r.integers(0, 256, (512, 128))
                           .astype(np.int32)).to(dev)
    bnc = torch.from_numpy(r.integers(0, 64, (512, 128))
                           .astype(np.int32)).to(dev)
    for bounce in (bnc, rng.JITTER_TAG):
        got = rng.planes_uniforms(pid, smp, bounce, 9, 0)
        want = rng.planes_uniforms_reference(pid, smp, bounce, 9, 0)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError(
                f"K3: kernel != plain, max |diff| "
                f"{(got - want).abs().max().item()}")
    log("2 K3 rng", "kernel == plain (torch.equal) on [9, 512, 128], "
        "bounce array and jitter tag")

    # ---- 3: K2, the bounce kernel ----
    text250 = random_gaussian_scene(250, seed=0)
    sc250 = parse_gmm(text250, device=dev)
    table250 = pathtrace.pack_table(sc250.medium)
    lights, env = sc250.lights(), sc250.env_color
    rr = np.random.default_rng(1)
    o = (rr.uniform(-1.5, 1.5, (RAYS, 3)) + [0.0, 1.0, 1.5])
    d = rr.normal(size=(RAYS, 3))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    xi = rr.uniform(size=(RAYS, 5))
    o, d, xi = (torch.tensor(a, dtype=torch.float32, device=dev)
                for a in (o, d, xi))
    k2_err = 0.0
    for finisher in (False, True):
        args = (table250, o, d, xi, lights, env, 12, finisher)
        got = pathtrace.bounce_step(*args)
        want = pathtrace.bounce_core_reference(*args)
        torch.cuda.synchronize()
        res = testing.bounce_agreement(got, want)
        k2_err = max(k2_err, res["max_dtau"])
        log("3 K2 bounce", f"finisher={finisher}: {json.dumps(res)}")
        if not res["ok"]:
            raise AssertionError(f"K2 misses BOUNCE_BARS: {res}")

    # ---- 4: K1, the megakernel ----
    def mega_args(sc, cam, cfg, ids):
        return (megatrace.camera_vector(cam), pathtrace.pack_table(sc.medium),
                ids, cfg, sc.lights(), sc.env_color,
                isinstance(cam, PinholeCamera))

    def small_k1(label, text, cam, cfg):
        sc = parse_gmm(text, device=dev)
        ids = torch.arange(cfg.width * cfg.height, dtype=torch.int32,
                           device=dev)
        args = mega_args(sc, cam, cfg, ids)
        res = testing.mega_agreement(megatrace.mega_call(*args),
                                     megatrace.mega_reference(*args), cfg.spp)
        log("4 K1 mega", f"{label}: {json.dumps(res)} (bars: max_diff 1e-4, "
            f"evals_rel 1e-2)")
        if not (res["finite"] and res["max_diff"] <= 1e-4
                and res["evals_rel"] <= 0.01):
            raise AssertionError(f"K1 {label} misses its bars: {res}")

    pin = PinholeCamera.create([0, 1, 6], [0, 1, 0], 0.25 * math.pi,
                               device=dev)
    ortho = OrthographicCamera.create([0, 1, 6], [0, 1, 0], device=dev)
    small = dict(diameter=(0.2, 0.6), density=(0.5, 2.0))
    cfg24 = RenderConfig(width=16, height=16, spp=9, max_bounces=6)
    small_k1("24 Gaussians 3 lights 16^2 spp 9",
             random_gaussian_scene(24, seed=7, **small), pin, cfg24)
    small_k1("24 Gaussians no lights 16^2 spp 9",
             random_gaussian_scene(24, seed=7, lights=(), **small), pin,
             cfg24)
    small_k1("16 Gaussians ortho 8^2 spp 4, RR from bounce 1, tail cap "
             "from 3", random_gaussian_scene(16, seed=9, diameter=(0.3, 0.8),
                                             density=(1.0, 3.0)), ortho,
             RenderConfig(width=8, height=8, spp=4, max_bounces=10,
                          min_scatter=1, rr_tail_after=3, rr_cap_tail=0.4))
    cfg64 = RenderConfig(width=64, height=64, spp=16)
    args = mega_args(sc250, pin, cfg64,
                     torch.from_numpy(tile_order(64, 64)).to(dev))
    got, want = megatrace.mega_call(*args), megatrace.mega_reference(*args)
    res = testing.mega_agreement(got, want, cfg64.spp)
    m_got, m_want = (x[0].mean().item() / cfg64.spp for x in (got, want))
    log("4 K1 mega", f"250 Gaussians 64^2 spp 16: means {m_got:.6f} vs "
        f"{m_want:.6f} (rel {abs(m_got - m_want) / m_want:.2e}, bar 1e-2), "
        f"{json.dumps(res)} (bar mean_diff 1e-3)")
    if not (abs(m_got - m_want) <= 0.01 * abs(m_want)
            and res["mean_diff"] < 1e-3 and res["finite"]):
        raise AssertionError("K1 250-Gaussian config misses its bars")

    # ---- 5: timing at the main path's shapes, K1 checked there too ----
    times = {}
    ids1 = torch.arange(RAYS, dtype=torch.int32, device=dev)
    times["rng"] = (
        cuda_ms(lambda: rng.planes_uniforms(ids1, ids1, ids1, 9, 0), 50)[0],
        cuda_ms(lambda: rng.planes_uniforms_reference(ids1, ids1, ids1, 9,
                                                      0), 10)[0])
    args = (table250, o, d, xi, lights, env, 12, False)
    times["bounce"] = (
        cuda_ms(lambda: pathtrace.bounce_step(*args), 10)[0],
        cuda_ms(lambda: pathtrace.bounce_core_reference(*args), 3)[0])
    order = tile_order(MAIN_SIZE, MAIN_SIZE)
    chunk = torch.from_numpy(
        order[MEDIUM_CHUNK * RAYS:(MEDIUM_CHUNK + 1) * RAYS]).to(dev)
    cam1k = PinholeCamera.create([0, 1, 6], [0, 1, 0], math.radians(45.0),
                                 device=dev)
    chunk_res = {}
    for spp in (4, MAIN_SPP):
        cfg = RenderConfig(width=MAIN_SIZE, height=MAIN_SIZE, spp=spp)
        args = mega_args(sc250, cam1k, cfg, chunk)
        k_ms, got = cuda_ms(lambda: megatrace.mega_call(*args), 3)
        t0 = time.perf_counter()
        p_ms, want = cuda_ms(lambda: megatrace.mega_reference(*args), 1,
                             warmup=spp == 4)
        times[f"mega_spp{spp}"] = (k_ms, p_ms)
        res = chunk_res[spp] = testing.mega_agreement(got, want, spp)
        log("5 timing", f"K1 chunk {MEDIUM_CHUNK} ({len(chunk)} px, rows "
            f"{MEDIUM_CHUNK * 64}-{MEDIUM_CHUNK * 64 + 63}) spp {spp}: "
            f"kernel {k_ms:.3f} ms, plain {p_ms:.3f} ms "
            f"({time.perf_counter() - t0:.1f} s); kernel vs plain "
            f"{json.dumps(res)} (bars {json.dumps(CHUNK_BARS)})")
    for spp, res in chunk_res.items():
        if not (res["finite"]
                and all(res[k] <= CHUNK_BARS[k] for k in CHUNK_BARS)):
            raise AssertionError(f"K1 at the main path's shape, spp {spp}, "
                                 f"misses its bars: {res}")
    log("5 timing", f"K3 [9, {RAYS}]: kernel {times['rng'][0]:.4f} ms, plain "
        f"{times['rng'][1]:.4f} ms; K2 {RAYS} rays N=250: kernel "
        f"{times['bounce'][0]:.3f} ms, plain {times['bounce'][1]:.3f} ms "
        f"({smi})")

    # ---- 6: the main path through the CLI ----
    counters = (rng.planes_uniforms, rng.planes_uniforms_reference,
                pathtrace.bounce_step, pathtrace.bounce_core_reference,
                megatrace.mega_call, megatrace.mega_reference)
    with tempfile.TemporaryDirectory() as tmp:
        scene_path = os.path.join(tmp, "random250.txt")
        out_path = os.path.join(tmp, "out.ppm")
        with open(scene_path, "w") as f:
            f.write(text250)
        for fn in counters:
            fn.launches = 0
        t0 = time.perf_counter()
        stats = cli.main(["render", scene_path, "-o", out_path, "--width",
                          str(MAIN_SIZE), "--height", str(MAIN_SIZE),
                          "--spp", str(MAIN_SPP), "--stats", "--device",
                          str(dev)])
        wall = time.perf_counter() - t0
        launches = {fn.__name__: fn.launches for fn in counters}
        img = read_ppm(out_path)
    if img.shape != (MAIN_SIZE, MAIN_SIZE, 3) or not np.isfinite(img).all() \
            or img.std() == 0:
        raise AssertionError(f"main path image: shape {img.shape}, "
                             f"std {img.std()}")
    if launches["mega_call"] == 0:
        raise AssertionError("main path never launched the megakernel")
    plain = {k: v for k, v in launches.items()
             if k.endswith("_reference") and v}
    if plain:
        raise AssertionError(f"main path called plain versions: {plain}")
    log("6 main", f"cli render 250 Gaussians {MAIN_SIZE}^2 spp {MAIN_SPP}: "
        f"render "
        f"{stats['seconds']:.3f} s ({wall:.3f} s with load and PPM), "
        f"{stats['paths'] / stats['seconds'] / 1e6:.3f} Mpaths/s, "
        f"{stats['bounce_evals'] / stats['seconds'] / 1e6:.3f} M bounce "
        f"evaluations/s ({stats['bounce_evals']} evaluations), image mean "
        f"{img.mean():.6f}, launches {json.dumps(launches)} ({smi})")

    def entry(name, replaces, key, launches_key, err):
        return {"name": name, "route": "cuda", "source": KERNEL_SOURCE,
                "replaces": replaces, "launches": launches[launches_key],
                "max_abs_err": err, "ms": times[key][0],
                "plain_ms": times[key][1]}

    kernels = [
        entry("mega", "gvr_tpu/kernels/megatrace.py:501",
              f"mega_spp{MAIN_SPP}", "mega_call",
              chunk_res[MAIN_SPP]["max_diff"]),
        entry("bounce", "gvr_tpu/kernels/pathtrace.py:465", "bounce",
              "bounce_step", k2_err),
        entry("rng", "gvr_tpu/kernels/rng.py:86", "rng", "planes_uniforms",
              0.0),
    ]
    # K2 and K3 run on the main path as device functions inside the
    # megakernel; their own launchers are not on it, so their launch counts
    # from the main path are 0 by design.
    kernels[1]["inside"] = kernels[2]["inside"] = "mega"
    kernels[0]["ms_spp4"], kernels[0]["plain_ms_spp4"] = times["mega_spp4"]
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    sys.exit(main())
