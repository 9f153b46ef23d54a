#!/usr/bin/env python3
"""Drive the gvr_tpu_torch main path on one CUDA card and check its kernels.

    python3 chip_smoke.py

Builds the CUDA kernels from gvr_tpu_torch/csrc (nvcc, at first use), holds
each kernel against its plain PyTorch version on the card, times both at
the main path's shapes, and renders the headline configuration and the
other forward paths (the dense XLA engine, single scatter, the ray
marchers, the hit mask) through the CLI.  One line per phase; any failure
raises, so the exit code is non-zero.

  0 card     nvidia-smi name and power limit, torch and nvcc versions
  1 build    nvcc seconds and ptxas register/spill lines
  2 K3 rng   kernel == plain (torch.equal), [9, 512, 128] draws, bounce
             array and the jitter tag; the grid wavefront's launcher
             (wave_uniforms, [2 + 9, 65,535]: jitter pair and bounce draws)
  3 K2 bounce  kernel vs plain, 250 Gaussians, 65,536 random rays,
             finisher off and on: the bars of testing.BOUNCE_BARS
  4 K1 mega  kernel vs plain at atol 1e-4 on 24 Gaussians 16^2 spp 9
             max_bounces 6, with 3 point lights and without, and on an ortho
             scene whose paths reach RR's tail cap; 250 Gaussians 64^2
             spp 16, image means within 1 % and per-pixel mean |diff| < 1e-3
  5 timing   each kernel's device time (torch.profiler, by kernel name;
             gvr_tpu_torch/kernels/timing.py) and the call's dispatch (its
             CUDA-events time less the device time), and its plain
             version's time (CUDA events), at the main path's shapes: K3
             as the wavefronts launch it ([2 + 9, 65536]; also the two
             launches it replaces and [9, 65536]), K2 65,536 rays at
             N = 250, K1 the headline's 65,536-pixel chunk through the
             medium at spp 4 and spp 64, there also held against the plain
             version (testing.CHUNK_BARS) and rendered three times more at
             spp 64, every output the same bits, and its first 2,048
             pixels at spp 64 and 1024 with the pool forced to 1, 8 and
             128 pixels, the same bits as the launcher's pool; K1's phase
             split at both (an instrumented launch: each phase's share of the warps' clock64() cycles and its
             active lanes per warp-step), its blocks resident per SM, and
             the work its paths need at spp 64 (a plain count on every 8th
             pixel, scaled: evaluations, those that scatter, the pairs
             their rays and shadow rays cross, the 32-row group boxes they
             meet and those groups' rows), from which its bounds
  6 main     `gvr_tpu_torch.cli render` of random_gaussian_scene(250, 0) at
             1024^2 spp 64; image finite and not constant, megakernel
             launched, no plain version called; rendered twice, the two
             PPMs the same bytes
  7 K6 span tau  kernel vs plain on the grid of random_gaussian_scene(10000,
             0), the DDA crossings of 65,536 random rays without and with
             tmax: on every slot |dtau| <= 1e-4 + 1e-3 |tau| plus the
             float32 resolution of the erf difference, and at most 0.1 % of
             the slots beyond 1e-4 + 1e-3 |tau| (testing.K6_BARS)
  8 K7 solve kernel vs plain on those rays' critical cells (u from a seed):
             t within 1e-5 + 1e-4 |t| on 99.9 % of the live rays, albedo
             within 1e-3 on 99.9 % of those (testing.K7_BARS)
  9 grid vs dense  render_multiscatter of random_gaussian_scene(120, 3,
             diameter 0.05-0.9) at 64^2 spp 16, engine='grid' against the
             megakernel: image means within 1 %
 10 grid timing  K6 and K7 device time, dispatch and plain ms at one
             iteration of the grid main path: K6 over the crossings of
             32,768 camera rays of the 512^2 image (tile-order chunk 4)
             and their 32,768 NEE rays, K7 over the scattered ones; both
             held there against their plain results at K6_BARS and
             K7_BARS; the entries K6 pre-tests and those its slots cross
             (gridtrace.span_work), the entries K7 solves and those its
             rays cross, and each bound with the pre-test and of a walk
             of whole cells
 11 grid main  `gvr_tpu_torch.cli render` of random_gaussian_scene(10000, 0)
             at 512^2 spp 16, engine auto: grid build seconds, render
             seconds, Mpaths/s, iterations, extension rays/s; image finite
             and not constant, K6/K7 launched, K3 launched once an
             iteration, no plain version called
 12 K4/K5 vs plain  random_gaussian_scene(10000, 0) (Morton-sorted, 40
             chunks): 8,192 tile-order camera rays of the 512^2 image
             through the medium and 8,192 rays from inside it, with the
             scene's 3 lights, with none, and with one light inside the
             medium (where K5's tmax clip matters): testing.BIG_BARS;
             then as many rays of the S_CAP_MAX fallback scene
             (random_gaussian_scene(8000, 0, diameter 2-4), 32 chunks),
             nearly all crossing more than MAX_HITS pairs:
             testing.BIG_DENSE_BARS.  Each kernel's box tests admit the
             chunks and groups the plain tests do, ray for ray, and K4
             counts the rays over MAX_HITS pairs as the plain count does.
             The share of rays over MAX_HITS, the chunks and groups
             admitted per ray
 13 big timing  K4 and K5 device time and dispatch (10 launches) and plain
             ms (CUDA events, 2)
             at one iteration of the big main path: the 65,536 lanes of
             chunk 2 of the 512^2 image, primary rays and after one
             bounce; the chunks and groups admitted per ray
             (K4 over [0, inf), K5 over [0, tmax]), the chunks holding a
             crossed pair, the pairs each ray crosses (mean, max), the
             share of rays over 32 and 64 of them, and each bound with
             culling (box tests, pre-tests of the admitted groups' pairs,
             pair tests of the crossed pairs) and of a full sweep (a pair
             test of every pair)
 14 big main `gvr_tpu_torch.cli render` of the 10k scene at 512^2 spp 16,
             engine dense (K8, K4, K5): render seconds, Mpaths/s,
             iterations, chunks; image finite, not constant, its mean
             within 1 % of phase 11's grid image of the same scene,
             camera, size, spp and seed; K8's two launches once an
             iteration, K3 not launched, no plain version called
 15 auto fallback  the fallback scene, whose grid exceeds S_CAP_MAX,
             through the CLI at 128^2 spp 4 with engine auto: dense with
             the big kernel, K4/K5 launched, host grid-build seconds,
             render seconds and Mpaths/s
 16 xla engine  the solvers the kernels do not implement take the dense
             XLA engine (plain PyTorch over [rays, N] arrays) through the
             CLI: random_gaussian_scene(250, 0) at 512^2 spp 16 with
             --solver bisection, analytic_bisection and uniform, each image
             finite and not constant, the first two (the exact solvers)
             with their means within 1 % of the megakernel's
             analytic_newton image at the same size and seed (UNIFORM is
             biased by design; its mean is reported); K8's two
             launches once an iteration, K1 and every plain version not called;
             render seconds, Mpaths/s, iterations.  Then the 10k scene at
             128^2 spp 4 with --solver bisection: engine auto takes the XLA
             engine, its chunk within the 2^25-element budget
 17 card vs cpu  the XLA engine (bisection and uniform, spp 4), single
             scatter (spp 4), both ray marchers (a coarser step, fewer
             environment samples) and the hit mask at 32^2 through the
             CLI on the card
             and with --device cpu: testing.CARD_CPU_BARS (image means
             within 0.5 %, per-pixel mean |diff| below 1e-3; the hit mask
             equal on 99.9 % of the pixels), K8 twice an iteration on the
             XLA engine, K3 launched as each other path draws (twice a
             chunk and sample, once a march step), no plain version
             called on the card
 18 at size  single scatter 512^2 spp 16, the analytic marcher at the
             CLI's step and environment samples at 256^2, the pure
             marcher at step 0.05 at 128^2, the hit mask at 1024^2:
             render seconds, chunk, steps, K3 launches
 19 fit card vs cpu  the inverse renderer on random_gaussian_scene(10, 2,
             diameter 0.2-0.7) at 16^2, 2 bounces, the parameters packed
             once on the CPU: fit_loss 'l2' and 'l2_dual' (spp 2), value
             and gradient, card against --device cpu at testing.FIT_BARS;
             multiscatter_radiance_diff at 32^2 (4 bounces, RR from 2)
             within testing.CARD_CPU_BARS; on the card K3 launched once
             for each buffer and sample and no plain version called; the
             implicit-function VJP of solve_conditional_free_flight
             against central differences on the card
             (testing.SOLVE_FD_BARS)
 20 fit main  `gvr_tpu_torch.cli render` of random_gaussian_scene(250, 0)
             at 128^2 spp 1024 gives the target; its packed parameters
             perturbed by N(0, 0.1) (numpy seed 7) give the initial scene,
             written as GMM text; `gvr_tpu_torch.cli fit` runs 40
             iterations at the CLI's settings (4,096-pixel batches, 4
             bounces, spp 2, lr 1e-2) with snapshots every 20: losses and
             final parameters finite, final.ppm and the snapshots written,
             K3 launched 4 times an iteration, K1 launched, no plain
             version; the fitted scene's 1024-spp render (final.ppm) must
             be closer to the target (PSNR) than the initial scene's;
             s/iteration, differentiable path-bounces/s, the dB gained
             and peak device memory

 21 media card vs cpu  random_sphere_scene(16, 0) through the CLI at 32^2
             on the card and with --device cpu (the sphere marcher, the pure
             marcher and the hit mask at phase 17's steps and environment
             samples); random_gaussian_scene(250, 0) baked at 64^3 on the
             card and on the CPU (testing.BAKE_BARS), the card's bake
             written as .npz and rendered by the CLI's pure marcher on
             both, and its hit mask by render_hit_mask (the CLI refuses a
             voxel hit mask, as the JAX package's does): testing.
             CARD_CPU_BARS, K3 once a march step, no plain version
 22 media at size  the sphere scene by `cli render --integrator raymarch`
             at 512^2, step 0.01, 20 environment samples; the Mitsuba scene
             of SURVEY 4.3 (written as XML: orthographic (0,1,6)->(0,1,0),
             512^2, the sky-blue constant emitter, a point light of 35 at
             (0,4,0), one sphere of radius 1 at (0,1,0), sigma_t 0.8, albedo
             0.875) by load_mitsuba + render_raymarch_spheres and its SMM
             twin, the images within 1e-5; the 250-Gaussian scene baked at
             128^3 (bake seconds) and its .npz by the CLI's pure marcher at
             phase 18's 128^2 and step 0.05, its image mean beside phase
             18's render of the Gaussians (no bar: a cell is wider than
             those Gaussians); 40 Gaussians of diameter 0.2-0.6 and their
             128^3 bake through the same marcher, the image means within
             3 % (BAKE_MEAN_BAR: the bake keeps the mass beyond R_CUT that
             the Gaussian renders drop): render seconds, steps, K3
             launches
 23 animate  `cli animate --integrator multiscatter` of the 250-Gaussian
             scene at the CLI's 512^2, spp 16, 120 frames, 30 fps (K1 once
             a chunk and frame), and `cli animate` (the sphere marcher) of
             the sphere scene at the CLI's step and environment samples,
             cut to 128^2 and 30 frames: seconds, seconds a frame, GIF
             bytes, launches; the GIF from the native encoder, GIF89a, the
             screen size, one image a frame and the trailer (the card's
             machine has no PIL), no plain version
 24 dp render  ranks 0-1 of a 4-rank gloo job that shares the card
             (parallel/launch.spawn of parallel/checks.card_suite; NCCL
             refuses ranks that share a card) render through
             render_multiscatter over a 2-rank mesh: the headline (K1), the
             10k scene at 512^2 spp 16 (grid: K3/K6/K7) and with
             --engine dense at 256^2 spp 4 (big-N: K8/K4/K5), and the
             headline with wavefront='step' (K8/K2, K2 once an iteration),
             each image equal to the one-process image of the same scene
             arrays bit for bit: seconds, the assembly's seconds, each
             rank's iterations and launches (counts set to 0 just
             before); then `torchrun
             --nproc-per-node 1 -m gvr_tpu_torch.cli render` of the headline
             over NCCL, its PPM the same bytes as phase 6's
 25 tp       render_multiscatter_tp of the 250-Gaussian scene over a
             (1 rays x 2 gauss) mesh at 128^2 spp 4, max_bounces 3, against
             the one-device sample loop (mc_camera_rays +
             multiscatter_radiance) at testing.TP_BARS: seconds,
             all-reduces; fit_value_and_grad_tp over a (2 x 2) mesh on the
             10-Gaussian scene at 16^2, 2 bounces, its loss and gathered
             gradient against fit_loss and backward at testing.FIT_BARS
 26 dp fit   fit_gaussians over ranks 0-1 from phase 20's initial scene
             toward its target for 5 iterations, and one process twice:
             the losses within rtol 1e-4 and the parameters within rtol
             1e-3 / atol 1e-5 of the one-process fit's after each of the
             first FIT_HELD_ITERS iterations (the trajectories of two
             summation orders of the batch part after that), the spread
             after every iteration printed, and that of two one-process
             fits; seconds an iteration
 27 trace    `cli render --trace DIR --stats` of the headline at 256^2
             spp 4: the trace names mega_kernel, the report holds the chunk
             and render_multiscatter spans and the trace the render's
             spans (render.prepare, chunk); `python -m
             gvr_tpu_torch.bench_series --size 256 --spp 4`: its rows
             finite, with the engine and grid columns
 28 step wavefront  render_multiscatter of the headline with
             RenderConfig(wavefront='step') (K8 twice and K2 once a
             wavefront iteration): kernel 'step', K2 and each K8 launch
             once an iteration, no megakernel and no plain version; the image
             within testing.CHUNK_BARS of K1's image of the same
             configuration (whose PPM is phase 6's), rendered twice, the
             same bits; render seconds, Mpaths/s, iterations.  In a
             process of its own (step_k2), K2 at the
             inputs of chunk 9's first iteration (65,536 lanes) and of its
             first with at most 1,024 lanes live: device time, dispatch,
             plain ms and bound (the pairs its rays cross, and a full
             sweep), held against the plain version at
             testing.PATH_BOUNCE_BARS (BOUNCE_BARS with tau missing its
             bar on at most 16 rays, by at most 2e-2: camera rays grazing
             a Gaussian's R_CUT clip part float32 from float64), both
             against the plain version in
             float64 (printed); the live lanes of that chunk's
             iterations.  `profile_render --wavefront step` of one
             65,536-lane chunk (256^2 spp 16) in a process of its own:
             the device's idle share and K2's share of the device time.
             random_gaussian_scene(300, 0) at 128^2 spp 4 with 'step':
             the big-N kernels, K2 not launched
 29 K8 glue  the dense wavefront's glue (kernels/wavefront.py) against its
             plain version run eagerly on the card, bit for bit, on 65,536
             random lanes of the 512^2 spp 16 image (testing.random_lanes):
             the pre-bounce launch's gathered rays and draws and the lane
             state, the post-bounce launch's state and mask, roulette
             draws at and one ulp above the survival probability; each
             launch's device time, dispatch and plain ms there (the
             pre-bounce launch on lanes that start no sample, so a call
             repeats the same work; the post-bounce launch after the
             lane state's restore), its bound (the lane state's bytes, each
             read and written once, over 3.35 TB/s) and its launches on
             phase 14's big-N render

The last three lines: the nvidia-smi line, the kernels JSON (each kernel
with its launches on its main path, its device time (``ms``), its call's
CUDA-events time and dispatch (``events_ms``, ``dispatch_us``), its plain
version's time, and its bound: the larger of its operations over 67
TFLOP/s and its bytes, each input read and each output written once,
over 3.35 TB/s; K1, K2, K4, K5, K6 and K7 also with ``bound_ms_sweep``,
the bound of the same work with a pair test of every pair instead of the
culling, the pre-test and the crossed-pair lists; K8's two launches
(wave_pre, wave_post) with their launches on the big-N render and on the
XLA engine (``launches_xla``); K1 also with
``bound_ms_pretest``, its own walk: a pre-test of every row instead of
the group boxes; K1 and K3 also with ``launches_fit``, their launches on
phase 20's fit; K2 with the step path's launches and times, its tail
iteration's in ``*_tail`` and phase 5's in ``*_random``), and the result
JSON.  Without a CUDA card, or without the package beside it, the script
exits non-zero before printing any result.
"""

import json
import math
import os
import re
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
# K1's bound counts the work of the paths of every COUNT_STRIDE-th pixel of
# chunk 9 at spp 64 (plain version, each path whole) and scales it by
# COUNT_STRIDE: a count of the whole chunk would cost a second plain run.
COUNT_STRIDE = 8
GRID_SIZE, GRID_SPP, GRID_N = 512, 16, 10_000   # the grid main path
GRID_CHUNK_INDEX = 4       # rows 256-319 of the 512^2 image, the centre
BIG_RAYS = 8192            # phase 12: camera rays, and as many inside
BIG_CHUNK_INDEX = 2        # rows 256-383 of the 512^2 image, 65,536 lanes
FALLBACK = dict(n=8000, seed=0, diameter=(2.0, 4.0))   # S_CAP_MAX refuses
# The dense XLA engine (phase 16): the headline scene at 512^2 spp 16 with
# each solver the kernels do not implement, and the 10k scene at 128^2
# spp 4 with bisection, which engine auto sends there too.
XLA_SIZE, XLA_SPP = 512, 16
XLA_SOLVERS = ("bisection", "analytic_bisection", "uniform")
XLA_BIG = (GRID_N, 128, 4)
# Phase 17: each new path at 32^2 on the card and on the CPU (the
# marchers at a coarser step and fewer environment samples than the
# CLI's, so the CPU's render stays short): (label, CLI arguments, spp,
# kernels it must launch on the card)
CARD_CPU_SIZE = 32
SLICE_PATHS = (
    ("multiscatter xla", ["--solver", "bisection"], 4,
     ["wave_pre", "wave_post"]),
    ("multiscatter xla uniform", ["--solver", "uniform"], 4,
     ["wave_pre", "wave_post"]),
    ("singlescatter", ["--integrator", "singlescatter"], 4,
     ["planes_uniforms"]),
    ("raymarch", ["--integrator", "raymarch", "--step-size", "0.02",
                  "--env-samples", "8"], 1, ["planes_uniforms"]),
    ("pureraymarch", ["--integrator", "pureraymarch", "--step-size", "0.1",
                      "--env-samples", "4"], 1, ["planes_uniforms"]),
    ("hitmask", ["--integrator", "hitmask"], 1, []),
)
# Phase 18: the integrators at size: (label, size, spp, CLI arguments,
# kernels).  The analytic marcher at the CLI's step (0.01) and environment
# samples (20) at 256^2, the pure marcher at step 0.05 and 128^2, both cut
# from the CLI's 512^2 so the phase stays within about a minute.
AT_SIZE = (
    ("singlescatter", 512, 16, ["--integrator", "singlescatter"],
     ["planes_uniforms"]),
    ("raymarch", 256, 1, ["--integrator", "raymarch"], ["planes_uniforms"]),
    ("pureraymarch", 128, 1, ["--integrator", "pureraymarch",
                              "--step-size", "0.05"], ["planes_uniforms"]),
    ("hitmask", 1024, 1, ["--integrator", "hitmask"], []),
)
# Phases 21-23: media and animation.  Phase 21 renders the sphere scene
# and a voxel bake at CARD_CPU_SIZE on the card and on the CPU (the bake
# at VOXEL_RES_CPU, so the CPU's part stays short); phase 22 the sphere
# scene at the CLI's 512^2, step 0.01 and 20 environment samples, the
# Mitsuba scene of SURVEY 4.3 (512^2, its film) and its SMM twin, and the
# bake at VOXEL_RES through the pure marcher at phase 18's 128^2 and step
# 0.05; phase 23 `cli animate` (label, scene, arguments, frames, size):
# multiscatter at the CLI's 512^2, spp 16 and 120 frames, and the sphere
# marcher at the CLI's step and environment samples, cut to 128^2 and 30
# frames (a 512^2 frame of it takes seconds, 120 of them minutes).
MAIN_SPHERE_SIZE = 512
VOXEL_RES_CPU, VOXEL_RES = 64, 128
# Gaussians a 128^3 grid resolves (the 250-Gaussian scene's are 0.01-0.035
# across, about a cell), for the bar between a medium and its bake
FAT_SCENE = dict(n=40, seed=0, diameter=(0.2, 0.6), density=(0.5, 2.0))
# their images' means: the bake keeps the 2.9 % of each Gaussian's mass
# beyond R_CUT that the Gaussian renders drop (phase 22)
BAKE_MEAN_BAR = 0.03
MITSUBA_XML = """<scene version="3.0.0">
  <integrator type="volpath"><integer name="max_depth" value="64"/></integrator>
  <sensor type="orthographic">
    <transform name="to_world">
      <lookat origin="0, 1, 6" target="0, 1, 0" up="0, 1, 0"/>
    </transform>
    <film type="hdrfilm">
      <integer name="width" value="512"/>
      <integer name="height" value="512"/>
    </film>
  </sensor>
  <emitter type="constant"><rgb name="radiance" value="0.53, 0.81, 0.92"/></emitter>
  <emitter type="point">
    <point name="position" x="0" y="4" z="0"/>
    <rgb name="intensity" value="35"/>
  </emitter>
  <medium type="homogeneous" id="sphere_medium">
    <rgb name="albedo" value="0.875"/>
    <rgb name="sigma_t" value="0.8"/>
    <float name="scale" value="1"/>
  </medium>
  <shape type="sphere">
    <point name="center" x="0" y="1" z="0"/>
    <float name="radius" value="1"/>
    <bsdf type="null"/>
    <ref name="interior" id="sphere_medium"/>
  </shape>
</scene>
"""
MITSUBA_TWIN = "l 0 4 0  35 35 35\ns 0 1 0  1.0 0.1 0.7\n"
ANIMATE = (
    ("multiscatter 250 Gaussians", "gaussians",
     ["--integrator", "multiscatter"], 120, 512),
    ("raymarch 16 spheres", "spheres", [], 30, 128),
)
# Phase 20: `cli fit` at the CLI's settings (batch, bounces, spp of each
# loss buffer), 40 iterations, at 128^2 with the target and the compared
# renders at the CLI's final spp
FIT_SIZE, FIT_ITERS, FIT_FINAL_SPP = 128, 40, 1024
FIT_BATCH, FIT_BOUNCES, FIT_SPP = 4096, 4, 2
# Phase 28: the step wavefront (RenderConfig(wavefront='step'), K2 once
# an iteration) on the headline; K2 timed at the inputs of the first
# iteration of the headline's chunk 9 (all 65,536 lanes live) and of its
# first iteration with at most STEP_TAIL_LANES live; profile_render of the
# step path at STEP_PROFILE (size, spp): one chunk of the headline's
# 65,536-lane width; and random_gaussian_scene(STEP_BIG_N, 0) at
# STEP_BIG_SIZE^2 spp 4, which 'step' sends to the big-N kernels
STEP_TAIL_LANES = 1024
STEP_PROFILE = (256, 16)
STEP_BIG_N, STEP_BIG_SIZE = 300, 128
# Phases 24-27: the data-parallel renders (label, scene, RenderConfig
# fields, the kernels each rank must launch), the tensor-parallel render,
# the data-parallel fit's iterations, the trace's size
DP_RANKS = 4
DP_RENDERS = (
    ("headline", "250", dict(width=MAIN_SIZE, height=MAIN_SIZE,
                             spp=MAIN_SPP), ("mega_call",)),
    ("grid", "10k", dict(width=GRID_SIZE, height=GRID_SIZE, spp=GRID_SPP),
     ("wave_uniforms", "span_tau_pass", "solve_pass")),
    ("big", "10k", dict(width=256, height=256, spp=4, engine="dense"),
     ("wave_pre", "wave_post", "big_stage1", "big_nee")),
    ("step", "250", dict(width=MAIN_SIZE, height=MAIN_SIZE, spp=MAIN_SPP,
                         wavefront="step"),
     ("wave_pre", "wave_post", "bounce_step")),
)
TP_CFG = dict(width=128, height=128, spp=4, max_bounces=3)
DP_FIT_ITERS = 5
# the data-parallel fit against one process (tests/test_gauss_sharded.py's
# trajectory bars): losses within FIT_LOSS_RTOL (beyond the log's 5
# decimals), parameters within FIT_RTOL |p| + FIT_ATOL
FIT_LOSS_RTOL, FIT_RTOL, FIT_ATOL = 1e-4, 1e-3, 1e-5
FIT_HELD_ITERS = 2             # the iterations those bars hold on
TRACE_SIZE, TRACE_SPP = 256, 4
# The card's peaks (NVIDIA H100 SXM data sheet): float32 outside the
# tensor cores and HBM bandwidth.  A kernel's bound is the larger of its
# operations over the first and its bytes over the second.
PEAK_FLOPS, PEAK_BYTES = 67e12, 3.35e12
# Flops of one (Gaussian, ray) pair test, csrc/bounce.cuh interval(), an
# FMA counted as 2: two 23-flop bilinear forms, q.d, b, t*, the closest
# point, m2, the gap and the interval.  A full sweep needs it once for
# each pair: every Gaussian for each ray in the sweep bounds of K1, K2, K4
# and K5, every entry of a crossed or solved cell in K6 and K7.
PAIR_TEST_FLOPS = 94
# Flops of one evaluation of a crossed pair at a point, bounce.cuh
# tau_sig_at(): z, the erf difference, the exp term and the two sums, an
# erff or expf counted as 1.  K1, K2, K4 and K7 need it for each pair a
# ray crosses in each pass (the tau pass, the solver's steps, the albedo);
# K5's and K6's erf/exp work is not counted, so those bounds are floors.
CROSSED_EVAL_FLOPS = 13
# Flops of one (box, ray) slab test, csrc/big.cuh box_admits: on each
# axis two subtractions, two products, a max and a min, then the compare;
# and of the division-free pre-test of a (Gaussian, ray) pair, may_cross:
# w = o - mu, A d, a, b, A w, c and the compare.  K4 and K5 need a box test
# for every chunk of every ray and for each group of a chunk the ray's own
# test admits, a pre-test for every Gaussian of the groups it admits, and
# a full pair test (PAIR_TEST_FLOPS) for each pair the ray crosses.  K1's
# rays (every bounce evaluation's extension ray, and the shadow-ray segment
# of each one that scatters) need the same over 32-row groups of its
# table in Morton order (megatrace.group_boxes; K1 itself pre-tests every
# row, bound_ms_pretest); K2 a pre-test of every row for each lane's
# extension and shadow rays and a pair test of each pair they cross
# (k2_bounds); K7 a pre-test of every entry of the solved cell and a pair
# test of each entry its ray crosses.
BOX_TEST_FLOPS = 19
PRE_TEST_FLOPS = 56
SOLVER_ITERS, GRID_SOLVER_ITERS = 12, 6     # the RenderConfig defaults
# K3: integer operations (the splitmix32 chain of csrc/rng.cuh): ~40 a
# (pixel, sample, bounce) key, ~20 of them its bounce half, ~14 a draw.
# planes_uniforms keys an element once and draws 9; the wavefronts'
# wave_uniforms keys a path once, two bounces, and draws 2 + 9.
RNG_OPS_PER_KEY = 40 + 9 * 14
RNG_OPS_PER_LANE = 40 + 20 + 11 * 14


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


def bound(ops, nbytes):
    """(bound_ms, bound_by) of work of ``ops`` operations that must move
    ``nbytes`` bytes."""
    t_ops, t_bytes = ops / PEAK_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3
    return max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def k2_bounds(args, t_sc):
    """(bound, full-sweep bound, crossed extension pairs, crossed shadow
    pairs) of one K2 launch on ``args`` (the arguments of
    ``pathtrace.bounce_step``), given its rays' t_sc.  K2
    solves every ray and traces every ray's shadow ray, so the work it
    needs is a pre-test of every row for both rays of each lane, a pair
    test and a tau evaluation of each pair they cross, and the Newton
    steps, the finisher if asked for and the albedo over each crossed
    extension pair; the full sweep has a pair test of every row in both."""
    import torch

    from gvr_tpu_torch.kernels import pathtrace as pt
    table, o, d, xi, lights, env, iters, finisher = args
    rows, b = table.shape[0], o.shape[0]
    col = lambda f: table[:, f:f + 1]
    ray = [v[:, k][None, :] for v in (o, d) for k in range(3)]
    ext = int(pt._interval(col, *ray, *pt._coeffs(col, *ray))[-1].sum())
    p, w, tmax, *_ = pt._nee_ray(ray, t_sc[None, :],
                                 *(xi[:, k][None, :] for k in range(1, 5)),
                                 lights)
    t0, t1, _, ok = pt._interval(col, *p, *w, *pt._coeffs(col, *p, *w))
    nee = int((ok & (torch.minimum(t1, tmax) > t0)).sum())
    nbytes = rows * 16 * 4 + b * (3 + 3 + 5 + 8) * 4
    ops = (PRE_TEST_FLOPS * rows * 2 * b
           + (PAIR_TEST_FLOPS + CROSSED_EVAL_FLOPS) * (ext + nee)
           + CROSSED_EVAL_FLOPS * (iters + int(finisher) + 1) * ext)
    return (bound(ops, nbytes),
            bound(2 * b * rows * PAIR_TEST_FLOPS, nbytes), ext, nee)


def step_k2():
    """Phase 28's K2 at the step path's shapes, in a process of its own:
    the inputs of the headline's chunk 9's first iteration and of its
    first with at most STEP_TAIL_LANES lanes live.  Prints its lines, and
    last {'err', 'full', 'tail'} as JSON."""
    import numpy as np
    import torch

    from gvr_tpu_torch import testing
    from gvr_tpu_torch.cameras import PinholeCamera
    from gvr_tpu_torch.config import RenderConfig
    from gvr_tpu_torch.integrators import multiscatter
    from gvr_tpu_torch.kernels import pathtrace
    from gvr_tpu_torch.kernels.timing import kernel_ms
    from gvr_tpu_torch.scene.generators import random_gaussian_scene
    from gvr_tpu_torch.scene.scene import parse_gmm

    dev = torch.device("cuda", 0)
    sc = parse_gmm(random_gaussian_scene(250, seed=0), device=dev)
    cam = PinholeCamera.create([0, 1, 6], [0, 1, 0], math.radians(45.0),
                               device=dev)
    cfg = RenderConfig(width=MAIN_SIZE, height=MAIN_SIZE, spp=MAIN_SPP,
                       wavefront="step")
    order = multiscatter.tile_order(MAIN_SIZE, MAIN_SIZE)
    ids = torch.from_numpy(
        order[MEDIUM_CHUNK * RAYS:(MEDIUM_CHUNK + 1) * RAYS]).to(dev)
    real, lanes, picked = multiscatter.bounce_step, [], {}

    def record(*args):
        lanes.append(args[1].shape[0])
        key = "full" if not picked else "tail"
        if key not in picked and (key == "full"
                                  or lanes[-1] <= STEP_TAIL_LANES):
            picked[key] = args
        return real(*args)

    multiscatter.bounce_step = record
    try:
        multiscatter.wavefront_pixels_step(sc, cam, cfg, ids)
    finally:
        multiscatter.bounce_step = real
    out = {"err": 0.0}
    for key, reps in (("full", 10), ("tail", 50)):
        args = picked[key]
        b = args[1].shape[0]
        t, got = kernel_ms(lambda: pathtrace.bounce_step(*args),
                           "bounce_kernel", reps)
        p_ms, want = cuda_ms(
            lambda: pathtrace.bounce_core_reference(*args), 3)
        agree = testing.bounce_agreement(got, want,
                                         testing.PATH_BOUNCE_BARS)
        # the plain version in float64 on the same inputs: how far each
        # float32 version is from the exact result
        f64 = [x.float() if x.is_floating_point() else x
               for x in pathtrace.bounce_core_reference(*(
                   a.double() if torch.is_tensor(a) else a for a in args))]
        vs64 = {name: testing.bounce_agreement(x, f64)
                for name, x in (("kernel", got), ("plain", want))}
        out["err"] = max(out["err"], agree["max_dtau"])
        culled, sweep, ext, nee = k2_bounds(args, want[0])
        out[key] = dict(lanes=b, t=t, plain_ms=p_ms, bound=culled,
                        bound_sweep=sweep)
        log("28 step wavefront", f"K2 at chunk {MEDIUM_CHUNK}'s {key} "
            f"iteration ({b} lanes): kernel {fmt_ms(t)}, plain "
            f"{p_ms:.3f} ms, bound {culled[0]:.5f} ms ({culled[1]}; "
            f"{ext} crossed extension pairs, {nee} crossed shadow pairs), "
            f"of a full sweep {sweep[0]:.5f} ms ({sweep[1]}); kernel vs "
            f"plain {json.dumps(agree)} "
            f"(bars {json.dumps(testing.PATH_BOUNCE_BARS)}); against the "
            f"plain version in float64: "
            + "; ".join(f"{k} max |dtau| {v['max_dtau']:.3e}, tau excess "
                        f"{v['tau_excess']:.3e} on {v['tau_beyond']} rays"
                        for k, v in vs64.items()))
        if not agree["ok"]:
            raise AssertionError(f"K2 at the step path's {key} iteration "
                                 f"misses PATH_BOUNCE_BARS: {agree}")
    lanes = np.asarray(lanes)
    log("28 step wavefront", f"chunk {MEDIUM_CHUNK}: {len(lanes)} "
        f"iterations, {int(lanes.sum())} lanes traced, "
        f"{int((lanes < 4096).sum())} iterations under 4,096 lanes, "
        f"{int((lanes < 128).sum())} under 128, lanes at iteration 0, 10, "
        f"100 and the last: "
        f"{[int(lanes[i]) for i in (0, 10, 100, -1) if i < len(lanes)]}")

    print(json.dumps(out))


def glue_phase(dev, smi):
    """Phase 29 (see the module docstring): K8 against its plain version
    and at 65,536 lanes.  Returns {launch: (times, plain ms, bound)}."""
    import torch

    from gvr_tpu_torch import testing
    from gvr_tpu_torch.cameras import PinholeCamera
    from gvr_tpu_torch.config import RenderConfig
    from gvr_tpu_torch.kernels import wavefront as wf
    from gvr_tpu_torch.kernels.timing import kernel_ms

    cam = PinholeCamera.create([0, 1, 6], [0, 1, 0], math.radians(45.0),
                               device=dev)
    cfg = RenderConfig(width=GRID_SIZE, height=GRID_SIZE, spp=GRID_SPP,
                       min_scatter=1, rr_tail_after=3)
    env = torch.tensor([0.3, 0.5, 0.9], device=dev)
    lanes, live, res, edges = testing.random_lanes(cfg, cam, RAYS, dev, 29)

    def clone(ln):
        return wf.Lanes(**{k: v.clone() if torch.is_tensor(v) else v
                           for k, v in vars(ln).items()})

    fields = ("o", "d", "thr", "acc", "alive", "sample", "bounce")
    differ = lambda a, b: [k for k in fields
                           if not torch.equal(getattr(a, k), getattr(b, k))]
    regen = int((~lanes.alive & (lanes.sample < cfg.spp)).sum())
    plain = clone(lanes)
    got = wf.wave_pre(lanes, live, cfg)
    want = wf.wave_pre_reference(plain, live, cfg)
    bad = [k for k, g, w in zip(("o", "d", "xi", "xr"), got, want)
           if not torch.equal(g, w)] + differ(lanes, plain)
    xr = got[3].clone()
    xr[0] = edges(plain, xr[0])
    after_pre = clone(lanes)
    k_post, p_post = clone(lanes), clone(plain)
    mask = wf.wave_post(k_post, live, xr, res, 4.0, env, cfg)
    mask_p = wf.wave_post_reference(p_post, live, xr, res, 4.0, env, cfg)
    torch.cuda.synchronize()
    bad += differ(k_post, p_post) + ([] if torch.equal(mask, mask_p)
                                     else ["want"])
    b, n = RAYS, live.shape[0]
    lives = int(k_post.alive.sum())
    log("29 K8 glue", f"kernel vs plain (eager on the card) on {b} random "
        f"lanes, {n} live, {regen} starting a sample, {lives} alive after "
        f"the bounce: {'bit-equal' if not bad else 'differ in ' + str(bad)}")
    if bad:
        raise AssertionError(f"K8 differs from its plain version in {bad}")

    def post():
        for k in fields:
            getattr(k_post, k).copy_(getattr(after_pre, k))
        return wf.wave_post(k_post, live, xr, res, 4.0, env, cfg)

    def post_plain():
        ln = clone(after_pre)
        return wf.wave_post_reference(ln, live, xr, res, 4.0, env, cfg)

    # bytes each launch must move, every field read and written once: the
    # pre-bounce launch reads a live lane's index, id, sample, bounce,
    # alive flag and ray (no ray for a lane that starts a sample) and
    # writes its ray, its 9 draws, slot and alive flag, and the new
    # sample's ray, throughput, sample and bounce; the post-bounce launch
    # reads every lane's flag, bounce and sample, a live lane's slot, ray,
    # throughput, sum, results and 3 draws, and writes every lane's
    # bounce and mask, a live lane's sum and flag and a survivor's ray
    # and throughput
    pre_bytes = n * (8 + 4 + 4 + 4 + 1 + 24) - regen * 24 \
        + n * (24 + 36 + 4 + 1) + regen * (24 + 12 + 8)
    post_bytes = b * (1 + 4 + 4) + n * (4 + 24 + 12 + 12 + 4 + 1 + 4 + 12
                                        + 12) \
        + b * (4 + 1) + n * (12 + 1) + lives * 36
    out = {}
    for name, fn, fn_plain, nbytes in (
            ("wave_pre", lambda: wf.wave_pre(lanes, live, cfg),
             lambda: wf.wave_pre_reference(clone(after_pre), live, cfg),
             pre_bytes),
            ("wave_post", post, post_plain, post_bytes)):
        t, _ = kernel_ms(fn, f"{name}_kernel", 20)
        p_ms, _ = cuda_ms(fn_plain, 3)
        out[name] = (t, p_ms, bound(0, nbytes))
        log("29 K8 glue", f"{name} {b} lanes ({n} live): kernel "
            f"{fmt_ms(t)}, plain (eager on the card) {p_ms:.3f} ms, bound "
            f"{out[name][2][0] * 1e3:.3f} us ({nbytes} bytes over 3.35 "
            f"TB/s) ({smi})")
    return out


def fmt_ms(t):
    """A ``kernel_ms`` result as text: device time, the call's dispatch, its
    CUDA-events time and the share of its launches the profiler
    recorded."""
    return (f"{t['ms']:.4f} ms (dispatch {t['dispatch_us']:.1f} us, events "
            f"{t['events_ms']:.4f} ms, {t['recorded']:.0%} of the launches "
            f"recorded)")


def media_phases(dev, smi, text250, counters, cli_render, cli_image,
                 pure_gaussians):
    """Phases 21-23 (media and animation); ``cli_render`` and
    ``cli_image`` are run()'s, ``pure_gaussians`` phase 18's pure-marcher
    image of the 250-Gaussian scene.  Returns K3's launches on the media
    renders and the turntables' launches."""
    import numpy as np
    import torch

    from gvr_tpu_torch import cli, testing
    from gvr_tpu_torch.cameras import PinholeCamera
    from gvr_tpu_torch.config import RenderConfig
    from gvr_tpu_torch.integrators.raymarch import render_raymarch_spheres
    from gvr_tpu_torch.integrators.test_hit import render_hit_mask
    from gvr_tpu_torch.io.mitsuba import load_mitsuba
    from gvr_tpu_torch.kernels import rng
    from gvr_tpu_torch.scene.generators import (random_gaussian_scene,
                                                random_sphere_scene)
    from gvr_tpu_torch.scene.scene import parse_gmm, parse_smm
    from gvr_tpu_torch.scene.voxels import VoxelGrid

    # ---- 21: media, card against CPU, through the CLI ----
    text16 = random_sphere_scene(16, seed=0)
    launches_m = {}

    def bake(text, device, res):
        """(scene, its Gaussians baked at res^3 on device as a VoxelGrid,
        seconds, the card synchronised).  The scene is parsed on the CPU
        and moved, so a bake on the card and one on the CPU start from
        the same mixture (eigh on the card rounds apart)."""
        sc = parse_gmm(text).to(device)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        vg = VoxelGrid.from_gaussians(sc.medium, res=res)
        torch.cuda.synchronize()
        return sc, vg, time.perf_counter() - t0

    def write_npz(path, sc, vg):
        np.savez(path, sigma_t=vg.sigma_t.cpu().numpy(),
                 albedo=vg.albedo.cpu().numpy(), lo=vg.lo.cpu().numpy(),
                 hi=vg.hi.cpu().numpy(), lights=sc.lights().cpu().numpy(),
                 env_color=sc.env_color.cpu().numpy())

    def card_vs_cpu(label, text, args, kernels, scene_file=None):
        stats, wall, launches_p, card = cli_render(
            text, CARD_CPU_SIZE, 1, kernels, args=args,
            scene_file=scene_file)
        stats_cpu, _, _, cpu = cli_image(text, CARD_CPU_SIZE, 1, "cpu",
                                         args, scene_file)
        res = testing.card_cpu_agreement(card, cpu,
                                         hitmask="hitmask" in label)
        launches_m[f"{label} {CARD_CPU_SIZE}"] = launches_p[
            "planes_uniforms"]
        log("21 media card vs cpu", f"{label} {CARD_CPU_SIZE}^2: card "
            f"{stats['seconds']:.3f} s, cpu {stats_cpu['seconds']:.3f} s, "
            + "".join(f"{k} {stats[k]}, " for k in (
                "k3_launches", "n_steps", "steps", "shadow_steps")
                if k in stats)
            + f"{json.dumps(res)} (bars "
            f"{json.dumps(testing.CARD_CPU_BARS)}), launches "
            f"{json.dumps({k: v for k, v in launches_p.items() if v})}")
        if not res["ok"]:
            raise AssertionError(f"{label}: the card's image misses the "
                                 f"CPU's: {res}")

    # each path at phase 17's coarser steps and environment samples
    marcher_args = {label: args for label, args, _, _ in SLICE_PATHS[3:]}
    for integrator in ("raymarch", "pureraymarch", "hitmask"):
        card_vs_cpu(f"spheres {integrator}", text16,
                    marcher_args[integrator],
                    [] if integrator == "hitmask" else ["planes_uniforms"])
    with tempfile.TemporaryDirectory() as tmp:
        sc_card, vg_card, _ = bake(text250, dev, VOXEL_RES_CPU)
        _, vg_cpu, _ = bake(text250, "cpu", VOXEL_RES_CPU)
        res = testing.bake_agreement(vg_card, vg_cpu)
        log("21 media card vs cpu", f"bake of 250 Gaussians at "
            f"{VOXEL_RES_CPU}^3, card vs cpu: {json.dumps(res)} (bars "
            f"{json.dumps(testing.BAKE_BARS)})")
        if not res["ok"]:
            raise AssertionError(f"the card's bake misses the CPU's: {res}")
        npz = os.path.join(tmp, "bake.npz")
        write_npz(npz, sc_card, vg_card)
        card_vs_cpu("voxels pureraymarch", None,
                    marcher_args["pureraymarch"], ["planes_uniforms"], npz)
        # the CLI refuses the hit mask of a voxel grid, as the JAX
        # package's does: the function renders it
        scv = sc_card.with_medium(vg_card)
        cam32 = PinholeCamera.create([0, 1, 6], [0, 1, 0],
                                     math.radians(45.0))
        cfg32 = RenderConfig(width=CARD_CPU_SIZE, height=CARD_CPU_SIZE)
        res = testing.card_cpu_agreement(
            render_hit_mask(scv, cam32, cfg32, device=dev),
            render_hit_mask(scv.to("cpu"), cam32, cfg32, device="cpu"),
            hitmask=True)
        log("21 media card vs cpu", f"voxels hitmask {CARD_CPU_SIZE}^2 "
            f"(render_hit_mask): {json.dumps(res)}")
        if not res["ok"]:
            raise AssertionError(f"voxel hit mask: card misses the CPU: "
                                 f"{res}")

    # ---- 22: media at size ----
    stats, wall, launches_p, img = cli_render(
        text16, MAIN_SPHERE_SIZE, 1, ["planes_uniforms"],
        args=["--integrator", "raymarch"])
    launches_m[f"spheres raymarch {MAIN_SPHERE_SIZE}"] = launches_p[
        "planes_uniforms"]
    log("22 media at size", f"cli render --integrator raymarch 16 spheres "
        f"{MAIN_SPHERE_SIZE}^2 step 0.01, 20 env samples: render "
        f"{stats['seconds']:.3f} s ({wall:.3f} s with load and PPM), steps "
        f"{stats['steps']} (bound {stats['n_steps']}) in {stats['chunks']} "
        f"chunks of {stats['chunk']}, K3 launches {stats['k3_launches']}, "
        f"image mean {img.mean():.6f} ({smi})")
    with tempfile.TemporaryDirectory() as tmp:
        xml = os.path.join(tmp, "one_sphere_ortho.xml")
        with open(xml, "w") as f:
            f.write(MITSUBA_XML)
        sc_x, cam_x, w_x, h_x = load_mitsuba(xml, device=dev)
        twin = parse_smm(MITSUBA_TWIN, device=dev)
        cfg_x = RenderConfig(width=w_x, height=h_x)
        imgs = []
        for label, sc in (("mitsuba xml", sc_x), ("smm twin", twin)):
            rng.planes_uniforms.launches = 0
            st = {}
            imgs.append(render_raymarch_spheres(sc, cam_x, cfg_x,
                                                device=dev, stats=st))
            launches_m[label] = rng.planes_uniforms.launches
            log("22 media at size", f"{label} (SURVEY 4.3: ortho "
                f"(0,1,6)->(0,1,0), one sphere r 1, sigma_t 0.8, albedo "
                f"0.875) {w_x}x{h_x} step 0.01, 20 env samples: render "
                f"{st['seconds']:.3f} s, steps {st['steps']}, K3 launches "
                f"{rng.planes_uniforms.launches} (due {st['k3_launches']}), "
                f"image mean {imgs[-1].mean():.6f}")
            if rng.planes_uniforms.launches != st["k3_launches"] \
                    or not np.isfinite(imgs[-1]).all():
                raise AssertionError(f"{label}: K3 or the image is off")
        diff = float(np.abs(imgs[0] - imgs[1]).max())
        log("22 media at size", f"mitsuba xml vs its smm twin: max |diff| "
            f"{diff:.3e} (bar 1e-5)")
        if diff > 1e-5 or imgs[0].std() == 0:
            raise AssertionError("the Mitsuba scene and its SMM twin differ")
        sc_v, vg_v, bake_s = bake(text250, dev, VOXEL_RES)
        npz = os.path.join(tmp, "bake128.npz")
        write_npz(npz, sc_v, vg_v)
        size, spp, args, kernels = AT_SIZE[2][1:]
        stats, wall, launches_p, img = cli_render(
            None, size, spp, kernels, args=args, scene_file=npz)
        launches_m[f"voxels pureraymarch {size}"] = launches_p[
            "planes_uniforms"]
        m_v, m_g = float(img.mean()), float(pure_gaussians.mean())
        log("22 media at size", f"bake of 250 Gaussians at {VOXEL_RES}^3 "
            f"(sigma_t and albedo {2 * VOXEL_RES ** 3 * 4 / 2**20:.0f} MiB): "
            f"{bake_s:.3f} s; cli render --integrator pureraymarch of the "
            f".npz {size}^2 step 0.05: render {stats['seconds']:.3f} s "
            f"({wall:.3f} s with load and PPM), steps {stats['steps']}, "
            f"shadow bound {stats['shadow_steps']}, K3 launches "
            f"{stats['k3_launches']}, image mean {m_v:.6f} vs the "
            f"Gaussians' {m_g:.6f} (phase 18; rel {abs(m_v - m_g) / m_g:.2e}; "
            f"no bar: Gaussians of sigma 0.005-0.018 are not resolved by a "
            f"cell of {float((vg_v.hi - vg_v.lo).max()) / VOXEL_RES:.4f}) "
            f"({smi})")
        # the cross-representation bar (tests/test_voxels.py's idea) on
        # Gaussians the grid resolves, through the same marcher, size and
        # step: the bake sums whole Gaussians, the Gaussian renders cut
        # each at R_CUT = 3 sigma, which drops 2.9 % of its mass, so the
        # bake is that much denser and its image darker
        text_fat = random_gaussian_scene(**FAT_SCENE)
        paths = {"gaussians": os.path.join(tmp, "fat.txt"),
                 "bake": os.path.join(tmp, "fat.npz")}
        with open(paths["gaussians"], "w") as f:
            f.write(text_fat)
        write_npz(paths["bake"], *bake(text_fat, dev, VOXEL_RES)[:2])
        imgs = []
        for label, path in paths.items():
            stats, wall, launches_p, img = cli_render(
                None, size, spp, kernels, args=args, scene_file=path)
            launches_m[f"fat {label} pureraymarch {size}"] = launches_p[
                "planes_uniforms"]
            imgs.append(img)
            log("22 media at size", f"40 Gaussians of diameter 0.2-0.6 "
                f"({label}{f' at {VOXEL_RES}^3' if label == 'bake' else ''})"
                f" cli render --integrator pureraymarch {size}^2 step 0.05: "
                f"render {stats['seconds']:.3f} s, steps {stats['steps']}, "
                f"K3 launches {stats['k3_launches']}, image mean "
                f"{img.mean():.6f}")
        m_g, m_v = (float(x.mean()) for x in imgs)
        log("22 media at size", f"bake vs Gaussians, image means: rel "
            f"{abs(m_v - m_g) / m_g:.2e} (bar {BAKE_MEAN_BAR}), mean |diff| "
            f"{float(np.abs(imgs[0] - imgs[1]).mean()):.2e}")
        if abs(m_v - m_g) > BAKE_MEAN_BAR * m_g:
            raise AssertionError("the bake's image mean misses the "
                                 "Gaussians'")

    # ---- 23: cli animate ----
    launches_a = {}
    for label, scene, args, frames, size in ANIMATE:
        text = text250 if scene == "gaussians" else text16
        with tempfile.TemporaryDirectory() as tmp:
            scene_path = os.path.join(tmp, "scene.txt")
            out_path = os.path.join(tmp, "anim.gif")
            with open(scene_path, "w") as f:
                f.write(text)
            for fn in counters:
                fn.launches = 0
            res = cli.main(["animate", scene_path, "-o", out_path,
                            "--frames", str(frames), "--width", str(size),
                            "--height", str(size)] + args)
            launches_p = {fn.__name__: fn.launches for fn in counters}
            with open(out_path, "rb") as f:
                structure = testing.gif_structure(f.read())
        launches_a[label] = {k: v for k, v in launches_p.items() if v}
        log("23 animate", f"cli animate {label} {size}^2 {' '.join(args)}, "
            f"{frames} frames: {res['seconds']:.3f} s, "
            f"{res['seconds'] / frames:.4f} s a frame, GIF {res['bytes']} "
            f"bytes ({res['backend']} encoder), {json.dumps(structure)}, "
            f"launches {json.dumps(launches_a[label])} ({smi})")
        plain = {k: v for k, v in launches_p.items()
                 if k.endswith("_reference") and v}
        if structure != dict(signature=True, width=size, height=size,
                             frames=frames, trailer=True) \
                or res["backend"] != "native" or plain:
            raise AssertionError(f"cli animate {label}: GIF {structure}, "
                                 f"backend {res['backend']}, plain {plain}")
        if "multiscatter" in args:
            due = frames * -(-size * size // RenderConfig().ray_chunk)
            if launches_p["mega_call"] != due:
                raise AssertionError(f"K1 launched {launches_p['mega_call']}"
                                     f" times, {due} due")
        elif not launches_p["planes_uniforms"]:
            raise AssertionError("the sphere turntable never launched K3")

    return launches_m, launches_a


def parallel_phases(dev, smi, texts, params10, main_img):
    """Phases 24-27 (see the module docstring): the data- and
    tensor-parallel paths on ranks that share the card, the torchrun CLI
    over NCCL, the trace and the scaling series."""
    import numpy as np
    import torch

    from gvr_tpu_torch import testing
    from gvr_tpu_torch.config import RenderConfig
    from gvr_tpu_torch.integrators.multiscatter import (
        mc_camera_rays, multiscatter_radiance, render_multiscatter)
    from gvr_tpu_torch.inverse.fit import fit_loss
    from gvr_tpu_torch.io.ppm import read_ppm
    from gvr_tpu_torch.parallel import checks
    from gvr_tpu_torch.parallel.launch import spawn
    from gvr_tpu_torch.scene.convert import (MIXTURE_FIELDS, SCENE_FIELDS,
                                             params_from_numpy,
                                             scene_from_numpy)
    from gvr_tpu_torch.scene.gaussians import GaussianMixture
    from gvr_tpu_torch.scene.scene import parse_gmm

    def arrays(sc):
        out = {k: getattr(sc.medium, k).detach().cpu().numpy()
               for k in MIXTURE_FIELDS}
        out.update({k: getattr(sc, k).cpu().numpy() for k in SCENE_FIELDS})
        return out

    # every rank and every reference start from one CPU parse's arrays
    scenes = {k: arrays(parse_gmm(t)) for k, t in texts.items()}
    sc_true = parse_gmm(texts["250"])
    p = sc_true.medium.pack_parameters().numpy()
    p = p + np.random.default_rng(7).normal(0, 0.1, p.shape) \
        .astype(np.float32)
    fit_init = arrays(sc_true.with_medium(
        GaussianMixture.from_parameters(torch.from_numpy(p))))
    cam = checks.camera(dev)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    target = render_multiscatter(
        scene_from_numpy(scenes["250"], dev), cam,
        RenderConfig(width=FIT_SIZE, height=FIT_SIZE, spp=FIT_FINAL_SPP),
        device=dev)
    inp = dict(dp=[(label, scenes[key], kw)
                   for label, key, kw, _ in DP_RENDERS],
               tp_scene=scenes["250"], tp_cfg=TP_CFG, fit_scene=scenes["10"],
               fit_params=params10.numpy(), fit_seed=5, fit_init=fit_init,
               fit_target=target, fit_iters=DP_FIT_ITERS,
               fit_batch=FIT_BATCH)
    t0 = time.perf_counter()
    ranks = spawn(checks.card_suite, DP_RANKS, inp, device=dev.type,
                  timeout=300.0, deadline=900.0)
    job = time.perf_counter() - t0

    # ---- 24: data-parallel renders against one process ----
    for label, key, kw, kernels in DP_RENDERS:
        res = [r["dp"][label] for r in ranks[:2]]
        cfg = RenderConfig(**kw)
        sc = scene_from_numpy(scenes[key], dev)
        one_stats = {}
        one = render_multiscatter(sc, cam, cfg, device=dev, stats=one_stats)
        img = res[0]["image"]           # rank 0 returns the image
        if not np.array_equal(img, one):
            raise AssertionError(f"dp {label}: image not the one-process "
                                 f"image, max |diff| "
                                 f"{np.abs(img - one).max():.3e}")
        for r, x in enumerate(res):
            plain = {k: v for k, v in x["launches"].items()
                     if k.endswith("_reference") and v}
            missing = [k for k in kernels if not x["launches"][k]]
            # the wavefronts launch K2 (the step path) once an iteration
            k2 = x["launches"]["bounce_step"]
            if x["stats"]["shards"] != 2 or missing or plain or (
                    k2 and k2 != x["stats"]["iterations"]):
                raise AssertionError(f"dp {label} rank {r}: shards "
                                     f"{x['stats']['shards']}, never "
                                     f"launched {missing}, plain {plain}, "
                                     f"K2 {k2} in "
                                     f"{x['stats']['iterations']} "
                                     f"iterations")
        log("24 dp render", f"{label} {cfg.width}^2 spp {cfg.spp} engine "
            f"{cfg.engine} ({res[0]['stats']['kernel']}) over 2 ranks: "
            f"image == one "
            f"process's bit for bit; seconds per rank "
            f"{[round(x['seconds'], 3) for x in res]} (one process "
            f"{one_stats['seconds']:.3f}), assembly "
            f"{[round(x['stats']['assemble_seconds'], 4) for x in res]} s, "
            f"chunk {res[0]['stats']['chunk']}, iterations per rank "
            f"{[x['stats']['iterations'] for x in res]} (one process "
            f"{one_stats['iterations']}), launches per rank "
            f"{json.dumps([{k: v for k, v in x['launches'].items() if v} for x in res])}"
            f" ({smi})")
    with tempfile.TemporaryDirectory() as tmp:
        scene_path, out = os.path.join(tmp, "s.txt"), os.path.join(tmp, "o.ppm")
        with open(scene_path, "w") as f:
            f.write(texts["250"])
        here = os.path.dirname(os.path.abspath(__file__))
        env = dict(os.environ, PYTHONPATH=here)
        t0 = time.perf_counter()
        run = subprocess.run(
            [sys.executable, "-m", "torch.distributed.run", "--standalone",
             "--nproc-per-node", "1", "-m", "gvr_tpu_torch.cli", "render",
             scene_path, "-o", out, "--width", str(MAIN_SIZE), "--height",
             str(MAIN_SIZE), "--spp", str(MAIN_SPP), "--stats", "--device",
             dev.type],
            cwd=here, env=env, capture_output=True, text=True, timeout=600)
        wall = time.perf_counter() - t0
        if run.returncode:
            raise AssertionError(f"torchrun cli render: exit "
                                 f"{run.returncode}\n{run.stdout[-2000:]}\n"
                                 f"{run.stderr[-4000:]}")
        banner = [x for x in run.stdout.splitlines() if "[gvr] rank" in x]
        ppm = np.rint(read_ppm(out) * 255).astype(np.int16)
    ref = np.rint(main_img * 255).astype(np.int16)
    bytes_off = int((ppm != ref).sum())
    log("24 dp render", f"torchrun --nproc-per-node 1 cli render 250 "
        f"{MAIN_SIZE}^2 spp {MAIN_SPP}: {banner}, {wall:.3f} s with "
        f"start-up; PPM bytes off phase 6's: {bytes_off} (bar: 0)")
    backend = "nccl" if dev.type == "cuda" else "gloo"
    if not (banner and backend in banner[0]) or bytes_off:
        raise AssertionError("the torchrun render did not run over NCCL or "
                             "its PPM is not phase 6's")

    # ---- 25: tensor parallel against one device ----
    sc = scene_from_numpy(scenes["250"], dev)
    cfg = RenderConfig(**TP_CFG)
    ids = torch.arange(cfg.width * cfg.height, dtype=torch.int32, device=dev)
    acc = torch.zeros((ids.shape[0], 3), device=dev)
    sync()
    t0 = time.perf_counter()
    for si in range(cfg.spp):
        o, d, rid = mc_camera_rays(sc, cam, cfg, ids, si)
        acc = acc + multiscatter_radiance(sc, o, d, rid, cfg, sample=si)
    want = (acc / cfg.spp).cpu().numpy()
    one_s = time.perf_counter() - t0
    tp = ranks[0]["tp"]["render"]
    res = testing.tp_agreement(tp["image"], want)
    log("25 tp", f"render_multiscatter_tp 250 Gaussians over (1 x 2) at "
        f"{cfg.width}^2 spp {cfg.spp} max_bounces {cfg.max_bounces}: "
        f"{tp['seconds']:.3f} s (one device {one_s:.3f} s), "
        f"{tp['allreduces']} all-reduces a rank, {json.dumps(res)} (bars "
        f"{json.dumps(testing.TP_BARS)}) ({smi})")
    if not res["ok"]:
        raise AssertionError(f"the TP render misses TP_BARS: {res}")
    sc10 = scene_from_numpy(scenes["10"], dev)
    o, d, ids = checks.pixel_rays(16, 16, dev)
    p = params_from_numpy(params10.numpy(), dev).requires_grad_(True)
    val = fit_loss(p, sc10, o, d, ids, torch.full((256, 3), 0.4, device=dev),
                   n_bounces=2, seed=5)
    val.backward()
    tpf = [r["tp"]["fit"] for r in ranks]
    res = testing.fit_agreement(tpf[0]["loss"], tpf[0]["grad"], val, p.grad)
    log("25 tp", f"fit_value_and_grad_tp 10 Gaussians over (2 x 2) at 16^2, "
        f"2 bounces: {max(x['seconds'] for x in tpf):.3f} s, "
        f"{json.dumps(res)} (bars {json.dumps(testing.FIT_BARS)})")
    if not res["ok"] or any(not np.array_equal(x["grad"], tpf[0]["grad"])
                            for x in tpf):
        raise AssertionError(f"the TP gradient misses FIT_BARS or differs "
                             f"between ranks: {res}")

    # ---- 26: the data-parallel fit against one process ----
    # the two ranks sum the batch's gradient in another order than one
    # process; Adam's normalised step turns such rounding in a small
    # gradient component into a move of a sizeable share of lr, and the
    # trajectories part after FIT_HELD_ITERS iterations on the card
    # (PERF.md): the bars hold on those iterations, the spread
    # after the rest is printed
    ones = [checks.logged_fit(scene_from_numpy(fit_init, dev), target,
                              DP_FIT_ITERS, FIT_BATCH) for _ in range(2)]
    fit = ranks[0]["fit"]

    def spread(x, y):
        """max |x - y| - rtol |y| of the parameters after each iteration,
        and the loss's relative difference beyond the log's 5 decimals."""
        return ([float(np.max(np.abs(a - b) - FIT_RTOL * np.abs(b)))
                 for a, b in zip(x["params"], y["params"])],
                [float(max(abs(a - b) - 1e-5, 0.0) / abs(b))
                 for a, b in zip(x["losses"], y["losses"])])

    (p_ab, l_ab), (p_dp, l_dp) = spread(ones[1], ones[0]), \
        spread(fit, ones[0])
    held = list(range(FIT_HELD_ITERS))
    log("26 dp fit", f"fit_gaussians 250 Gaussians {FIT_SIZE}^2 over 2 "
        f"ranks, {DP_FIT_ITERS} iterations: "
        f"{fit['seconds'] / DP_FIT_ITERS:.4f} s an iteration (one process "
        f"{ones[0]['seconds'] / DP_FIT_ITERS:.4f}, "
        f"{ones[1]['seconds'] / DP_FIT_ITERS:.4f}); losses "
        f"{fit['losses']} vs {ones[0]['losses']}; parameters max(|diff| - "
        f"1e-3 |p|) after each iteration: 2 ranks vs one process "
        f"{[float(f'{x:.3e}') for x in p_dp]}, one process vs one process "
        f"{[float(f'{x:.3e}') for x in p_ab]}; held at rtol 1e-4 (losses) "
        f"and rtol 1e-3 / atol 1e-5 (parameters) on iterations {held}; "
        f"the job of "
        f"{DP_RANKS} ranks {job:.3f} s with start-up ({smi})")
    if len(fit["params"]) != DP_FIT_ITERS or any(p_dp[i] > FIT_ATOL or l_dp[i] > FIT_LOSS_RTOL
                   for i in held) \
            or not all(np.array_equal(a, b) for a, b in zip(
                fit["params"], ranks[1]["fit"]["params"])):
        raise AssertionError("the data-parallel fit misses the one-process "
                             "fit")

    trace_phase(dev, smi, texts["250"])


def trace_phase(dev, smi, text250):
    """Phase 27: `cli render --trace --stats` and the scaling series, each
    in a process of its own, as a user runs them (late in a long process
    torch.profiler may record none of a short run's launches; PERF.md)."""
    import numpy as np

    from gvr_tpu_torch.utils.profiling import TRACE_FILE

    here = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=here)
    with tempfile.TemporaryDirectory() as tmp:
        scene_path = os.path.join(tmp, "s.txt")
        with open(scene_path, "w") as f:
            f.write(text250)
        run = subprocess.run(
            [sys.executable, "-m", "gvr_tpu_torch.cli", "render", scene_path,
             "-o", os.path.join(tmp, "o.ppm"), "--width", str(TRACE_SIZE),
             "--height", str(TRACE_SIZE), "--spp", str(TRACE_SPP),
             "--trace", os.path.join(tmp, "trace"), "--stats", "--device",
             dev.type], cwd=here, env=env, capture_output=True, text=True,
            timeout=600)
        if run.returncode:
            raise AssertionError(f"cli render --trace: exit "
                                 f"{run.returncode}\n{run.stderr[-4000:]}")
        path = os.path.join(tmp, "trace", TRACE_FILE)
        size = os.path.getsize(path) if os.path.exists(path) else 0
        with open(path) as f:
            text = f.read()
        named = "mega_kernel" in text
        traced = [n for n in ("render.prepare", "chunk", "render.readback")
                  if f'"name": "{n}"' in text]
    spans = [x.split(":")[0][len("[gvr] "):] for x in run.stdout.splitlines()
             if x.startswith("[gvr] ")]
    log("27 trace", f"cli render --trace --stats 250 Gaussians "
        f"{TRACE_SIZE}^2 spp {TRACE_SPP}: trace {size} bytes, names "
        f"mega_kernel: {named}, spans {traced}, report spans {spans}")
    if not named or len(traced) < 3 or "chunk" not in spans \
            or "render_multiscatter" not in spans:
        raise AssertionError("the trace or the report is incomplete")
    t0 = time.perf_counter()
    run = subprocess.run(
        [sys.executable, "-m", "gvr_tpu_torch.bench_series", "--size",
         str(TRACE_SIZE), "--spp", str(TRACE_SPP), "--device", dev.type],
        cwd=here, env=env, capture_output=True, text=True, timeout=600)
    if run.returncode:
        raise AssertionError(f"bench_series: exit {run.returncode}\n"
                             f"{run.stderr[-4000:]}")
    rows = json.loads(run.stdout.strip().splitlines()[-1])["series"]
    log("27 trace", f"bench_series --size {TRACE_SIZE} --spp {TRACE_SPP} "
        f"({time.perf_counter() - t0:.3f} s): {json.dumps(rows)} ({smi})")
    if not rows or not all(np.isfinite(v) for r in rows for v in r.values()
                           if isinstance(v, (int, float))):
        raise AssertionError(f"bench_series rows: {rows}\n{run.stdout}")


def step_phase(dev, smi, text250, counters, main_img):
    """Phase 28 (see the module docstring): the step wavefront on the
    headline, K2 at its shapes, its profile and its big-N hand-off.
    Returns K2's numbers for the kernels line."""
    import numpy as np

    from gvr_tpu_torch import testing
    from gvr_tpu_torch.cameras import PinholeCamera
    from gvr_tpu_torch.config import RenderConfig
    from gvr_tpu_torch.integrators import multiscatter
    from gvr_tpu_torch.io.ppm import quantize
    from gvr_tpu_torch.scene.generators import random_gaussian_scene
    from gvr_tpu_torch.scene.scene import parse_gmm

    sc = parse_gmm(text250, device=dev)
    cam = PinholeCamera.create([0, 1, 6], [0, 1, 0], math.radians(45.0),
                               device=dev)
    cfg = RenderConfig(width=MAIN_SIZE, height=MAIN_SIZE, spp=MAIN_SPP,
                       wavefront="step")

    def render(c, scene=sc):
        """(image, stats, launches) of a render with every count set to 0
        just before."""
        for fn in counters:
            fn.launches = 0
        stats = {}
        img = multiscatter.render_multiscatter(scene, cam, c, device=dev,
                                               stats=stats)
        return img, stats, {fn.__name__: fn.launches for fn in counters}

    # K1's image of the same configuration in float: phase 6's PPM bytes
    mega, _, _ = render(cfg.replace(wavefront="mega"))
    same_ppm = bool(np.array_equal(
        quantize(mega), np.rint(main_img * 255).astype(np.uint8)))
    img, stats, launches = render(cfg)
    it = stats["iterations"]
    res = testing.image_agreement(img, mega, cfg.spp)
    log("28 step wavefront", f"render_multiscatter 250 Gaussians "
        f"{MAIN_SIZE}^2 spp {cfg.spp} wavefront='step': kernel "
        f"{stats['kernel']}, render {stats['seconds']:.3f} s, "
        f"{stats['paths'] / stats['seconds'] / 1e6:.3f} Mpaths/s, {it} "
        f"iterations over {stats['chunks']} chunks, "
        f"{stats['bounce_evals']} bounce evaluations, launches "
        f"{json.dumps({k: v for k, v in launches.items() if v})}; against "
        f"K1's image of the same configuration (its PPM == phase 6's: "
        f"{same_ppm}): {json.dumps(res)} (bars "
        f"{json.dumps(testing.CHUNK_BARS)}) ({smi})")
    plain = {k: v for k, v in launches.items()
             if k.endswith("_reference") and v}
    if not (stats["kernel"] == "step" and it > 0
            and launches["bounce_step"] == it
            and launches["wave_pre"] == launches["wave_post"] == it
            and not launches["wave_uniforms"]
            and not launches["mega_call"] and not plain
            and img.shape == (MAIN_SIZE, MAIN_SIZE, 3)):
        raise AssertionError(f"the step render: kernel {stats['kernel']}, "
                             f"{it} iterations, launches {launches}")
    if not res["ok"] or not same_ppm:
        raise AssertionError(f"the step image misses K1's: {res}, PPM "
                             f"{same_ppm}")
    again, _, _ = render(cfg)
    log("28 step wavefront", f"rendered again: bit-equal "
        f"{np.array_equal(again, img)}")
    if not np.array_equal(again, img):
        raise AssertionError("two step renders of the headline differ")

    # K2 at the path's shapes, in a process of its own: late in a long
    # process the profiler may record none of a short run's launches
    # (PERF.md), and here it recorded none of K2's in three windows
    here = os.path.dirname(os.path.abspath(__file__))
    run = subprocess.run(
        [sys.executable, "-c", "import chip_smoke; chip_smoke.step_k2()"],
        cwd=here, env=dict(os.environ, PYTHONPATH=here), capture_output=True,
        text=True, timeout=900)
    if run.returncode:
        raise AssertionError(f"K2 at the step path's shapes: exit "
                             f"{run.returncode}\n{run.stderr[-4000:]}")
    lines = run.stdout.strip().splitlines()
    for line in lines[:-1]:
        print(line, flush=True)
    out = json.loads(lines[-1])

    # where the step path's time goes: one chunk of the headline's width,
    # in a process of its own (PERF.md: late in a long process the
    # profiler may record none of a short run's launches)
    size, spp = STEP_PROFILE
    run = subprocess.run(
        [sys.executable, "-m", "gvr_tpu_torch.profile_render",
         "--gaussians", "250", "--size", str(size), "--spp", str(spp),
         "--wavefront", "step", "--top", "12", "--device", dev.type],
        cwd=here, env=dict(os.environ, PYTHONPATH=here), capture_output=True,
        text=True, timeout=600)
    if run.returncode:
        raise AssertionError(f"profile_render --wavefront step: exit "
                             f"{run.returncode}\n{run.stderr[-4000:]}")
    prof = json.loads(run.stdout.strip().splitlines()[-1])
    k2_ms = [float(m.group(1)) for m in re.finditer(
        r"^\s*([\d.]+) ms dev .*bounce_kernel", run.stdout, re.M)]
    out["profile"] = dict(
        idle_share=1.0 - prof["busy_share"],
        k2_share=(k2_ms[0] / prof["device_busy_ms"] if k2_ms else None),
        **{k: prof[k] for k in ("warm_seconds", "device_busy_ms",
                                "iterations", "launches_per_iteration")})
    log("28 step wavefront", f"profile_render --gaussians 250 --size {size} "
        f"--spp {spp} --wavefront step: {json.dumps(out['profile'])}; top "
        f"rows by device time:\n" + "\n".join(
            run.stdout.split("--- by host time")[0].splitlines()[1:8]))
    if prof["kernel"] != "step" or not k2_ms:
        raise AssertionError(f"the profile did not see K2: {prof}")

    # above MAX_PALLAS_GAUSSIANS 'step' takes the big-N kernels
    big = parse_gmm(random_gaussian_scene(STEP_BIG_N, seed=0), device=dev)
    img, stats, launches = render(RenderConfig(
        width=STEP_BIG_SIZE, height=STEP_BIG_SIZE, spp=4, wavefront="step"),
        big)
    log("28 step wavefront", f"{STEP_BIG_N} Gaussians {STEP_BIG_SIZE}^2 "
        f"spp 4 wavefront='step': kernel {stats['kernel']}, "
        f"{stats['seconds']:.3f} s, launches "
        f"{json.dumps({k: v for k, v in launches.items() if v})}")
    if stats["kernel"] != "big" or launches["bounce_step"] \
            or not launches["big_stage1"] or not np.isfinite(img).all():
        raise AssertionError(f"'step' above 256 Gaussians: {stats}, "
                             f"{launches}")
    out["launches"] = it
    return out


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
    from gvr_tpu_torch.accel.grid import build_grid, dda_crossings
    from gvr_tpu_torch.cameras import OrthographicCamera, PinholeCamera
    from gvr_tpu_torch.config import RenderConfig
    from gvr_tpu_torch.integrators import gridscatter
    from gvr_tpu_torch.integrators.multiscatter import (
        GRID_CHUNK, render_multiscatter, tile_order)
    from gvr_tpu_torch.io.ppm import read_ppm
    from gvr_tpu_torch.kernels import (_build, gridtrace, megatrace,
                                       pathtrace, pathtrace_big, rng)
    from gvr_tpu_torch.kernels.timing import kernel_ms
    from gvr_tpu_torch.ops.sampling import dir_from_xi
    from gvr_tpu_torch.parallel.checks import counted_kernels
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
    kernel = "?"
    for line in info["log"].splitlines():
        m = re.search(r"Compiling entry function '_ZN3gvr(\d+)", line)
        if m:
            start = m.end()
            kernel = line[start:start + int(m.group(1))]
        elif "registers" in line or "spill" in line:
            log("1 build", f"ptxas {kernel}: " + line.strip())

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
    lanes = RAYS - 1                   # not a multiple of the block
    flat = [t.reshape(-1)[:lanes] for t in (pid, smp, bnc)]
    got = rng.wave_uniforms(*flat, 0)
    want = rng.wave_uniforms_reference(*flat, 0)
    torch.cuda.synchronize()
    if not torch.equal(got, want):
        raise AssertionError("K3 wave_uniforms: kernel != plain")
    log("2 K3 rng", f"kernel == plain (torch.equal) on [9, 512, 128], "
        f"bounce array and jitter tag; wave_uniforms [11, {lanes}]")

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
    # times[key] = (kernel_ms's dict, plain ms by CUDA events)
    times = {}
    ids1 = torch.arange(RAYS, dtype=torch.int32, device=dev)
    buf = torch.empty((11, RAYS), dtype=torch.float32, device=dev)
    times["rng"] = (
        kernel_ms(lambda: rng.wave_uniforms(ids1, ids1, ids1, 0, out=buf),
                  "wave_uniforms_kernel", 50)[0],
        cuda_ms(lambda: rng.wave_uniforms_reference(ids1, ids1, ids1, 0),
                10)[0])
    # what one wavefront iteration launched before: the jitter pair and the
    # bounce's draws in two launches
    times["rng_two"] = (kernel_ms(lambda: (
        rng.planes_uniforms(ids1, ids1, rng.JITTER_TAG, 2, 0),
        rng.planes_uniforms(ids1, ids1, ids1, 9, 0)), "uniforms_kernel",
        50, per_call=2)[0], None)
    times["rng_planes"] = (
        kernel_ms(lambda: rng.planes_uniforms(ids1, ids1, ids1, 9, 0),
                  "uniforms_kernel", 50)[0],
        cuda_ms(lambda: rng.planes_uniforms_reference(ids1, ids1, ids1, 9,
                                                      0), 10)[0])
    args = (table250, o, d, xi, lights, env, 12, False)
    times["bounce"] = (
        kernel_ms(lambda: pathtrace.bounce_step(*args), "bounce_kernel",
                  10)[0],
        cuda_ms(lambda: pathtrace.bounce_core_reference(*args), 3)[0])
    k2_random = k2_bounds(args, pathtrace.bounce_core_reference(*args)[0])
    order = tile_order(MAIN_SIZE, MAIN_SIZE)
    chunk = torch.from_numpy(
        order[MEDIUM_CHUNK * RAYS:(MEDIUM_CHUNK + 1) * RAYS]).to(dev)
    cam1k = PinholeCamera.create([0, 1, 6], [0, 1, 0], math.radians(45.0),
                                 device=dev)
    chunk_res = {}
    per_sm, sms = megatrace.resident_blocks(dev)
    for spp in (4, MAIN_SPP):
        cfg = RenderConfig(width=MAIN_SIZE, height=MAIN_SIZE, spp=spp)
        args = mega_args(sc250, cam1k, cfg, chunk)
        k_t, got = kernel_ms(lambda: megatrace.mega_call(*args),
                             "mega_kernel", 3)
        t0 = time.perf_counter()
        p_ms, want = cuda_ms(lambda: megatrace.mega_reference(*args), 1,
                             warmup=spp == 4)
        times[f"mega_spp{spp}"] = (k_t, p_ms)
        res = chunk_res[spp] = testing.chunk_agreement(got, want, spp)
        log("5 timing", f"K1 chunk {MEDIUM_CHUNK} ({len(chunk)} px, rows "
            f"{MEDIUM_CHUNK * 64}-{MEDIUM_CHUNK * 64 + 63}) spp {spp}: "
            f"kernel {fmt_ms(k_t)}, plain {p_ms:.3f} ms "
            f"({time.perf_counter() - t0:.1f} s); kernel vs plain "
            f"{json.dumps(res)} (bars {json.dumps(testing.CHUNK_BARS)})")
        phases = torch.zeros((len(megatrace.MEGA_PHASES), 3),
                             dtype=torch.int64, device=dev)
        megatrace.mega_call(*args, phases=phases)
        split = megatrace.phase_split(phases)
        log("5 timing", f"K1 phase split spp {spp} (share of the warps' "
            f"cycles, active lanes per warp-step): " + ", ".join(
                f"{k} {v[0] * 100:.1f} % {v[1]:.1f}"
                for k, v in split.items())
            + f"; {per_sm} blocks resident per SM, {sms} SMs; counters "
            f"{phases.tolist()}")
    # K1 is reproducible: chunk 9 three times more, the same bits as the
    # timed launch's output
    equal = [all(torch.equal(x, y) for x, y in
                 zip(megatrace.mega_call(*args), got)) for _ in range(3)]
    log("5 timing", f"K1 chunk {MEDIUM_CHUNK} spp {MAIN_SPP} three times "
        f"more: radiance and evaluation counts bit-equal to the first "
        f"{equal}")
    if not all(equal):
        raise AssertionError("K1 is not reproducible on chunk 9")
    # ... and does not depend on its pool: chunk 9's first 2,048 pixels at
    # spp 64 and 1024 with the pool forced to 1, 8 and 128 pixels a block
    # (at spp 1024 every pool runs in rounds), the launcher's pool's bits
    own_pool = megatrace.pool_pixels
    for spp in (MAIN_SPP, 1024):
        cfg = RenderConfig(width=MAIN_SIZE, height=MAIN_SIZE, spp=spp)
        args = mega_args(sc250, cam1k, cfg, chunk[:2048])
        want = megatrace.mega_call(*args)
        equal = {}
        try:
            for pix in (1, 8, 128):
                megatrace.pool_pixels = lambda *_, p=pix: p
                equal[pix] = all(torch.equal(x, y) for x, y in
                                 zip(megatrace.mega_call(*args), want))
        finally:
            megatrace.pool_pixels = own_pool
        log("5 timing", f"K1 chunk {MEDIUM_CHUNK}'s first 2048 px spp "
            f"{spp}, pools forced to 1, 8, 128 px: bit-equal to the "
            f"launcher's pool of {own_pool(spp, 2048, per_sm * sms)} px "
            f"{equal}")
        if not all(equal.values()):
            raise AssertionError(f"K1 depends on its pool at spp {spp}")
    # the work chunk 9's paths need at spp 64, counted by the plain version
    # on every COUNT_STRIDE-th pixel and scaled
    sample = {}
    cfg = RenderConfig(width=MAIN_SIZE, height=MAIN_SIZE, spp=MAIN_SPP)
    megatrace.mega_reference(*mega_args(sc250, cam1k, cfg,
                                        chunk[::COUNT_STRIDE]), counts=sample)
    work = {k: v if k == "groups" else v * COUNT_STRIDE
            for k, v in sample.items()}
    rows = table250.shape[0]
    rays = work["evals"] + work["scattered"]
    # a pair test and a tau-pass evaluation of each pair the rays cross,
    # and each crossed pair of a ray that scatters in the Newton steps and
    # the albedo pass
    pair_flops = ((PAIR_TEST_FLOPS + CROSSED_EVAL_FLOPS)
                  * (work["ext_pairs"] + work["nee_pairs"])
                  + CROSSED_EVAL_FLOPS * (SOLVER_ITERS + 1)
                  * work["solve_pairs"])
    mega_bytes = table250.numel() * 4 + RAYS * (4 + 12 + 4)
    bounds = {
        # wave_uniforms: pid, sample, bounce in, 2 + 9 planes out
        "rng": bound(RNG_OPS_PER_LANE * RAYS, (3 + 11) * 4 * RAYS),
        "rng_planes": bound(RNG_OPS_PER_KEY * RAYS, (3 + 9) * 4 * RAYS),
        # K2 on phase 3's random rays: the pairs they cross, and a full
        # sweep
        "bounce": k2_random[0],
        "bounce_sweep": k2_random[1],
        # each ray's box test of every group, a pre-test of each row of
        # the groups it meets, and the crossed pairs' work
        f"mega_spp{MAIN_SPP}": bound(
            BOX_TEST_FLOPS * rays * work["groups"] + PRE_TEST_FLOPS
            * (work["ext_rows"] + work["nee_rows"]) + pair_flops,
            mega_bytes),
        # K1's own walk: a pre-test of every row of the table in each sweep
        "mega_pretest": bound(PRE_TEST_FLOPS * rows * rays + pair_flops,
                              mega_bytes),
        # a pair test of every row in both sweeps
        "mega_sweep": bound(rays * rows * PAIR_TEST_FLOPS, mega_bytes),
    }
    log("5 timing", f"K1 chunk {MEDIUM_CHUNK} spp {MAIN_SPP} work (plain "
        f"count of every {COUNT_STRIDE}th pixel, x {COUNT_STRIDE}): "
        f"{json.dumps(work)}; bound {bounds[f'mega_spp{MAIN_SPP}'][0]:.4f} "
        f"ms ({bounds[f'mega_spp{MAIN_SPP}'][1]}), with K1's pre-test of "
        f"every row {bounds['mega_pretest'][0]:.4f} ms, of a full sweep "
        f"{bounds['mega_sweep'][0]:.4f} ms")
    for spp, res in chunk_res.items():
        if not res["ok"]:
            raise AssertionError(f"K1 at the main path's shape, spp {spp}, "
                                 f"misses its bars: {res}")
    log("5 timing", f"K3 wave_uniforms [11, {RAYS}]: kernel "
        f"{fmt_ms(times['rng'][0])}, plain {times['rng'][1]:.4f} ms, bound "
        f"{bounds['rng'][0]:.5f} ms; the two launches it replaces (planes "
        f"[2] + [9]): {fmt_ms(times['rng_two'][0])}; planes_uniforms "
        f"[9, {RAYS}]: kernel {fmt_ms(times['rng_planes'][0])}, plain "
        f"{times['rng_planes'][1]:.4f} ms, bound "
        f"{bounds['rng_planes'][0]:.5f} ms; K2 {RAYS} rays N=250: kernel "
        f"{fmt_ms(times['bounce'][0])}, plain {times['bounce'][1]:.3f} ms, "
        f"bound {bounds['bounce'][0]:.5f} ms ({k2_random[2]} crossed "
        f"extension pairs, {k2_random[3]} crossed shadow pairs), of a full "
        f"sweep {bounds['bounce_sweep'][0]:.5f} ms ({smi})")

    # ---- 6: the main path through the CLI ----
    counters = counted_kernels()

    def cli_image(text, size, spp, device, args=(), scene_file=None):
        """(stats, wall seconds, launches, image) of ``text`` (or of the
        file ``scene_file``) rendered through the CLI on ``device`` with
        ``args``, every count set to 0 just before."""
        with tempfile.TemporaryDirectory() as tmp:
            scene_path = scene_file or os.path.join(tmp, "scene.txt")
            out_path = os.path.join(tmp, "out.ppm")
            if scene_file is None:
                with open(scene_path, "w") as f:
                    f.write(text)
            for fn in counters:
                fn.launches = 0
            t0 = time.perf_counter()
            stats = cli.main(["render", scene_path, "-o", out_path,
                              "--width", str(size), "--height", str(size),
                              "--spp", str(spp), "--stats", "--device",
                              str(device)] + list(args))
            wall = time.perf_counter() - t0
            launches = {fn.__name__: fn.launches for fn in counters}
            return stats, wall, launches, read_ppm(out_path)

    def cli_render(text, size, spp, kernels, engine="auto", args=(),
                   scene_file=None):
        """Render ``text`` (or ``scene_file``) through the CLI on the card
        with every count set to 0 just before; returns (stats, wall
        seconds, launches, image) after checking the image, that each of
        ``kernels`` was launched and that no plain version was called."""
        stats, wall, launches, img = cli_image(
            text, size, spp, dev, ["--engine", engine] + list(args),
            scene_file)
        if img.shape != (size, size, 3) or not np.isfinite(img).all() \
                or img.std() == 0:
            raise AssertionError(f"main path image: shape {img.shape}, "
                                 f"std {img.std()}")
        missing = [k for k in kernels if launches[k] == 0]
        if missing:
            raise AssertionError(f"main path never launched {missing}")
        # K3's launches: wave_uniforms once a grid iteration, or
        # planes_uniforms as the other integrators draw (their
        # k3_launches: twice a chunk and sample in single scatter, once a
        # march step in the marchers); the dense wavefronts draw inside
        # K8, whose two launches come once an iteration
        for k3, other, due in (
                ("wave_uniforms", "planes_uniforms", "iterations"),
                ("planes_uniforms", "wave_uniforms", "k3_launches")):
            if k3 in kernels and (launches[k3] != stats[due]
                                  or launches[other]):
                raise AssertionError(
                    f"K3 launched {launches[k3]} + {launches[other]} times "
                    f"where {stats[due]} were due")
        if "wave_pre" in kernels and not (
                launches["wave_pre"] == launches["wave_post"]
                == stats["iterations"] and not launches["wave_uniforms"]
                and not launches["planes_uniforms"]):
            raise AssertionError(
                f"K8 launched {launches['wave_pre']} + "
                f"{launches['wave_post']} times, K3 "
                f"{launches['wave_uniforms']} + "
                f"{launches['planes_uniforms']}, where "
                f"{stats['iterations']} iterations ran")
        plain = {k: v for k, v in launches.items()
                 if k.endswith("_reference") and v}
        if plain:
            raise AssertionError(f"main path called plain versions: {plain}")
        return stats, wall, launches, img

    stats, wall, launches, img = cli_render(text250, MAIN_SIZE, MAIN_SPP,
                                            ["mega_call"])
    main_img = img
    log("6 main", f"cli render 250 Gaussians {MAIN_SIZE}^2 spp {MAIN_SPP}: "
        f"render "
        f"{stats['seconds']:.3f} s ({wall:.3f} s with load and PPM), "
        f"{stats['paths'] / stats['seconds'] / 1e6:.3f} Mpaths/s, "
        f"{stats['bounce_evals'] / stats['seconds'] / 1e6:.3f} M bounce "
        f"evaluations/s ({stats['bounce_evals']} evaluations), image mean "
        f"{img.mean():.6f}, launches {json.dumps(launches)} ({smi})")
    # K1 is reproducible: a second CLI render writes the same PPM bytes
    again = cli_render(text250, MAIN_SIZE, MAIN_SPP, ["mega_call"])[3]
    log("6 main", f"cli render again: PPM bytes equal to the first "
        f"{np.array_equal(again, img)}")
    if not np.array_equal(again, img):
        raise AssertionError("two CLI renders of the headline differ")

    # ---- 7: K6, the grid span-tau kernel ----
    text10k = random_gaussian_scene(GRID_N, seed=0)
    sc10k = parse_gmm(text10k, device=dev)
    t0 = time.perf_counter()
    grid = build_grid(sc10k.medium)
    log("7 K6 span tau", f"grid of {GRID_N} Gaussians: side {grid.side}, "
        f"s_cap {grid.s_cap}, {grid.n_entries} entries, at most "
        f"{int(grid.cell_count.max())} in a cell, host build "
        f"{time.perf_counter() - t0:.3f} s")
    rays_tmax = torch.tensor(rr.uniform(0.1, 4.0, RAYS), dtype=torch.float32,
                             device=dev)
    no_tmax = torch.full((RAYS,), 1e8, dtype=torch.float32, device=dev)
    k6_err = 0.0
    for label, tmax in (("no tmax", None), ("tmax 0.1-4", rays_tmax)):
        cells, _, t_out = dda_crossings(grid, o, d, tmax)
        tm = no_tmax if tmax is None else tmax
        got = gridtrace.span_tau_pass(grid, o, d, tm, cells)
        want = gridtrace.span_tau_reference(grid, o, d, tm, cells)
        torch.cuda.synchronize()
        res = testing.span_tau_agreement(got, want, grid, cells, t_out)
        k6_err = max(k6_err, res["max_err"])
        log("7 K6 span tau", f"{label}, {RAYS} rays: {json.dumps(res)} "
            f"(bars {json.dumps(testing.K6_BARS)})")
        if not res["ok"]:
            raise AssertionError(f"K6 {label} misses K6_BARS: {res}")

    # ---- 8: K7, the grid cell-solve kernel ----
    u = torch.tensor(rr.uniform(size=RAYS), dtype=torch.float32, device=dev)
    tau, cells, t_in, t_out = gridscatter.grid_tau_crossings(grid, o, d)
    _, _, cell_c, tin_c, tout_c, resid = gridscatter.critical_crossing(
        grid, tau, cells, t_in, t_out, u)
    args = (grid, o, d, tin_c, tout_c, resid, cell_c, 6)
    got, want = gridtrace.solve_pass(*args), gridtrace.solve_reference(*args)
    torch.cuda.synchronize()
    k7 = testing.solve_agreement(got, want, cell_c)
    log("8 K7 solve", f"{RAYS} random rays: {json.dumps(k7)} (bars "
        f"{json.dumps(testing.K7_BARS)})")
    if not (k7["ok"] and k7["n"] > 1000):
        raise AssertionError(f"K7 misses K7_BARS: {k7}")

    # ---- 9: the grid engine against the megakernel ----
    sc120 = parse_gmm(random_gaussian_scene(120, seed=3,
                                            diameter=(0.05, 0.9)),
                      device=dev)
    cfg = RenderConfig(width=64, height=64, spp=16)
    img_g, img_d = (render_multiscatter(sc120, pin, cfg.replace(engine=e),
                                        device=dev) for e in ("grid", "dense"))
    m_g, m_d = float(img_g.mean()), float(img_d.mean())
    log("9 grid vs dense", f"120 Gaussians 64^2 spp 16: image means "
        f"{m_g:.6f} (grid) vs {m_d:.6f} (megakernel), rel "
        f"{abs(m_g - m_d) / m_d:.2e} (bar 1e-2), per-pixel mean |diff| "
        f"{float(np.abs(img_g - img_d).mean()):.3e}")
    if not (np.isfinite(img_g).all() and abs(m_g - m_d) <= 0.01 * m_d):
        raise AssertionError("grid engine misses the megakernel's mean")

    # ---- 10: K6 and K7 timing at one grid iteration's shapes ----
    n_ext = GRID_CHUNK                   # one chunk of the grid main path
    cam512 = PinholeCamera.create([0, 1, 6], [0, 1, 0], math.radians(45.0),
                                  device=dev)
    px = torch.from_numpy(tile_order(GRID_SIZE, GRID_SIZE)[
        GRID_CHUNK_INDEX * n_ext:(GRID_CHUNK_INDEX + 1) * n_ext]).to(dev)
    uv = torch.stack([(px % GRID_SIZE + 0.5) / GRID_SIZE,
                      (px // GRID_SIZE + 0.5) / GRID_SIZE], dim=-1).float()
    o_e, d_e = cam512.sample_ray(uv)
    xi_e = torch.tensor(rr.uniform(size=(n_ext, 5)), dtype=torch.float32,
                        device=dev)
    tau, cells, t_in, t_out = gridscatter.grid_tau_crossings(grid, o_e, d_e)
    scattered, _, cell_c, tin_c, tout_c, resid = \
        gridscatter.critical_crossing(grid, tau, cells, t_in, t_out,
                                      xi_e[:, 0])
    t_sc, _ = gridtrace.solve_pass(grid, o_e, d_e, tin_c, tout_c, resid,
                                   cell_c)
    pos = o_e + torch.clamp(t_sc, min=0.0)[:, None] * d_e
    wi, tmax_n, _, _ = gridscatter._nee_select(sc10k, pos, xi_e[:, 1],
                                               xi_e[:, 2], xi_e[:, 3:5])
    o2, d2 = torch.cat([o_e, pos]), torch.cat([d_e, wi])
    tmax2 = torch.cat([torch.full((n_ext,), 1e8, device=dev),
                       torch.where(scattered, tmax_n, 0.0)])
    cells2, _, t_out2 = dda_crossings(grid, o2, d2, tmax2)
    k6_t, got = kernel_ms(
        lambda: gridtrace.span_tau_pass(grid, o2, d2, tmax2, cells2),
        "span_tau_kernel", 20)
    p_ms, want = cuda_ms(
        lambda: gridtrace.span_tau_reference(grid, o2, d2, tmax2, cells2), 2)
    times["span_tau"] = (k6_t, p_ms)
    k6_main = testing.span_tau_agreement(got, want, grid, cells2, t_out2)
    k6_err = max(k6_err, k6_main["max_err"])
    dda_ms = cuda_ms(lambda: dda_crossings(grid, o2, d2, tmax2), 10)[0]
    args = (grid, o_e, d_e, tin_c, tout_c, resid, cell_c, 6)
    k7_t, got = kernel_ms(lambda: gridtrace.solve_pass(*args),
                          "grid_solve_kernel", 20)
    p_ms, want = cuda_ms(lambda: gridtrace.solve_reference(*args), 2)
    times["grid_solve"] = (k7_t, p_ms)
    k7_main = testing.solve_agreement(got, want, cell_c)
    log("10 grid timing", f"K6 over {int((cells2 >= 0).sum())} crossings of "
        f"{2 * n_ext} rays (chunk {GRID_CHUNK_INDEX} of {GRID_SIZE}^2 and "
        f"its NEE rays): kernel {fmt_ms(times['span_tau'][0])}, plain "
        f"{times['span_tau'][1]:.3f} ms, kernel vs plain "
        f"{json.dumps(k6_main)}; DDA (plain torch) {dda_ms:.3f} ms; "
        f"K7 over {int(scattered.sum())} scattered of {n_ext} rays: kernel "
        f"{fmt_ms(times['grid_solve'][0])}, plain "
        f"{times['grid_solve'][1]:.3f} ms, kernel vs plain "
        f"{json.dumps(k7_main)} ({smi})")
    crossings = grid.cell_count[cells2[cells2 >= 0].long()].sum().item()
    solved = grid.cell_count[cell_c[cell_c >= 0].long()].sum().item()
    crossed7 = gridtrace.crossed_entries(grid, o_e, d_e, tin_c, tout_c,
                                         cell_c).sum().item()
    visited6, crossed6 = (int(x.sum()) for x in gridtrace.span_work(
        grid, o2, d2, tmax2, cells2))
    cell_bytes = grid.table.numel() * 4 + grid.n_cells * 8
    k6_bytes = cell_bytes + o2.shape[0] * 7 * 4 + cells2.numel() * 8
    # K6: a pre-test of each entry of each slot's cell where the slot's
    # clip is not empty, a pair test and an evaluation of each entry that
    # the ray crosses inside it; the sweep bound a pair test of every
    # entry of every crossed cell instead
    bounds["span_tau"] = bound(
        visited6 * PRE_TEST_FLOPS
        + crossed6 * (PAIR_TEST_FLOPS + CROSSED_EVAL_FLOPS), k6_bytes)
    bounds["span_tau_sweep"] = bound(crossings * PAIR_TEST_FLOPS, k6_bytes)
    # K7: a pre-test for each entry of the solved cells and a pair test for
    # each entry the ray crosses, then the crossed entries in the tau pass,
    # the Newton steps and the albedo pass; the sweep bound a pair test of
    # every entry instead
    crossed_evals = crossed7 * (GRID_SOLVER_ITERS + 2) * CROSSED_EVAL_FLOPS
    bounds["grid_solve"] = bound(
        solved * PRE_TEST_FLOPS + crossed7 * PAIR_TEST_FLOPS + crossed_evals,
        cell_bytes + n_ext * 12 * 4)
    bounds["grid_solve_sweep"] = bound(solved * PAIR_TEST_FLOPS
                                       + crossed_evals,
                                       cell_bytes + n_ext * 12 * 4)
    log("10 grid timing", f"K6 {crossings} entries of crossed cells, "
        f"{visited6} pre-tested (clip not empty), {crossed6} crossed, bound "
        f"{bounds['span_tau'][0]:.4f} ms (walking whole cells "
        f"{bounds['span_tau_sweep'][0]:.4f} ms); K7 {solved} entries of solved "
        f"cells, {crossed7} crossed, bound {bounds['grid_solve'][0]:.4f} ms "
        f"(walking whole cells {bounds['grid_solve_sweep'][0]:.4f} ms)")
    if not (k6_main["ok"] and k7_main["ok"]):
        raise AssertionError(f"K6/K7 at the main path's shapes miss their "
                             f"bars: {k6_main} {k7_main}")
    k7_err = max(k7["t_max"], k7_main["t_max"])

    # ---- 11: the grid main path through the CLI ----
    stats, wall, launches_g, img_grid = cli_render(
        text10k, GRID_SIZE, GRID_SPP,
        ["span_tau_pass", "solve_pass", "wave_uniforms"])
    if stats["engine"] != "grid":
        raise AssertionError(f"engine auto took {stats['engine']}")
    log("11 grid main", f"cli render {GRID_N} Gaussians {GRID_SIZE}^2 spp "
        f"{GRID_SPP}: grid build {stats['grid_seconds']:.3f} s, render "
        f"{stats['seconds']:.3f} s ({wall:.3f} s with load and PPM), "
        f"{stats['paths'] / stats['seconds'] / 1e6:.3f} Mpaths/s, "
        f"{stats['iterations']} iterations in {stats['chunks']} chunks, "
        f"{stats['bounce_evals']} extension rays "
        f"({stats['bounce_evals'] / stats['seconds'] / 1e6:.3f} M/s), image "
        f"mean {img_grid.mean():.6f}, launches {json.dumps(launches_g)} "
        f"({smi})")

    # ---- 12: K4 and K5, the big-N kernels, against their plain versions
    pb = pathtrace_big

    def mean(t):
        return t.float().mean().item()

    def cull_line(st, n_c):
        return (f"rays over MAX_HITS={pb.MAX_HITS} pairs "
                f"{mean(st['crossed'] > pb.MAX_HITS):.4f}, chunks admitted "
                f"per ray {mean(st['admitted']):.2f} of {n_c}, groups per "
                f"ray {mean(st['groups']):.2f} of {8 * n_c}")

    table10k, boxes10k = pb.pack_rows(sc10k.medium), pb.chunk_boxes(
        sc10k.medium)
    o12, d12, xi12 = testing.big_rays(sc10k.medium, BIG_RAYS, 12, dev)
    inside = torch.tensor([[0.0, 1.0, 0.0, 5.0, 5.0, 5.0]], device=dev)
    k4_err = k5_err = 0.0
    for label, lts in (("3 lights", sc10k.lights()),
                       ("no lights", sc10k.lights()[:0]),
                       ("a light inside the medium", inside)):
        res = testing.big_kernel_vs_plain(table10k, boxes10k, o12, d12, xi12,
                                          lts, sc10k.env_color)
        k4_err, k5_err = max(k4_err, res["max_dtau"]), max(k5_err,
                                                           res["max_dli"])
        log("12 K4/K5 vs plain", f"{GRID_N} Gaussians "
            f"({table10k.shape[0] // pb.G} chunks), {2 * BIG_RAYS} "
            f"rays, {label}: {json.dumps(res)} (bars "
            f"{json.dumps(testing.BIG_BARS)})")
        if not res["ok"]:
            raise AssertionError(f"K4/K5 {label} miss BIG_BARS: {res}")
    log("12 K4/K5 vs plain", f"{GRID_N} Gaussians: " + cull_line(
        pb.culling_stats(table10k, boxes10k, o12, d12),
        table10k.shape[0] // pb.G))
    text_fb = random_gaussian_scene(FALLBACK["n"], seed=FALLBACK["seed"],
                                    diameter=FALLBACK["diameter"])
    sc_fb = parse_gmm(text_fb, device=dev)
    table_fb, boxes_fb = pb.pack_rows(sc_fb.medium), pb.chunk_boxes(
        sc_fb.medium)
    o_fb, d_fb, xi_fb = testing.big_rays(sc_fb.medium, BIG_RAYS, 12, dev)
    res = testing.big_kernel_vs_plain(table_fb, boxes_fb, o_fb, d_fb, xi_fb,
                                      sc_fb.lights(), sc_fb.env_color,
                                      bars=testing.BIG_DENSE_BARS)
    st = pb.culling_stats(table_fb, boxes_fb, o_fb, d_fb)
    log("12 K4/K5 vs plain", f"fallback scene ({FALLBACK['n']} Gaussians of "
        f"diameter 2-4, {table_fb.shape[0] // pb.G} chunks), {2 * BIG_RAYS} "
        f"rays, 3 lights: {cull_line(st, table_fb.shape[0] // pb.G)}; "
        f"{json.dumps(res)} (bars {json.dumps(testing.BIG_DENSE_BARS)})")
    if not res["ok"] or mean(st["crossed"] > pb.MAX_HITS) < 0.9:
        raise AssertionError(f"K4/K5 on the fallback scene miss "
                             f"BIG_DENSE_BARS: {res}")
    k4_err, k5_err = max(k4_err, res["max_dtau"]), max(k5_err,
                                                       res["max_dli"])

    # ---- 13: K4 and K5 timing at one big main-path iteration's shapes ----
    lanes = torch.from_numpy(tile_order(GRID_SIZE, GRID_SIZE)[
        BIG_CHUNK_INDEX * RAYS:(BIG_CHUNK_INDEX + 1) * RAYS]).to(dev)
    uv = torch.stack([(lanes % GRID_SIZE + 0.5) / GRID_SIZE,
                      (lanes // GRID_SIZE + 0.5) / GRID_SIZE], dim=-1).float()
    o13, d13 = cam512.sample_ray(uv)
    xi13 = torch.tensor(rr.uniform(size=(2, RAYS, 5)), dtype=torch.float32,
                        device=dev)
    lights10k, env10k = sc10k.lights(), sc10k.env_color
    s1 = pb.big_stage1(table10k, o13, d13, xi13[0], lights10k,
                       boxes=boxes10k)
    moved = (s1[1] > 0.5)[:, None]
    o13b = torch.where(moved, o13 + s1[0][:, None] * d13, o13)
    d13b = torch.where(moved, dir_from_xi(xi13[1, :, 3:5]), d13)
    n_c = table10k.shape[0] // pb.G
    for label, o_, d_, x_ in (("primary", o13, d13, xi13[0]),
                              ("after one bounce", o13b, d13b, xi13[1])):
        args = (table10k, o_, d_, x_, lights10k)
        k4_t, s1 = kernel_ms(lambda: pb.big_stage1(*args, boxes=boxes10k),
                             "big_stage1_kernel", 10)
        p4_ms, s1_plain = cuda_ms(lambda: pb.big_stage1_reference(*args), 2)
        k5_t, li = kernel_ms(lambda: pb.big_nee(table10k, s1, env10k,
                                                boxes10k), "big_nee_kernel",
                             10)
        p5_ms, li_plain = cuda_ms(
            lambda: pb.big_nee_reference(table10k, s1, env10k), 2)
        res = testing.big_agreement(
            (s1[0], s1[1] > 0.5, s1[2], li, s1[3]),
            (s1_plain[0], s1_plain[1] > 0.5, s1_plain[2], li_plain,
             s1_plain[3]))
        st4 = pb.culling_stats(table10k, boxes10k, o_, d_)
        st5 = pb.culling_stats(table10k, boxes10k, s1[4:7].T, s1[7:10].T,
                               s1[10])
        crossed = st4["crossed"]
        key = "" if label == "primary" else "_bounce1"
        times["big_stage1" + key] = (k4_t, p4_ms)
        times["big_nee" + key] = (k5_t, p5_ms)
        # K4: a box test for each (ray, chunk) and for each group of the
        # chunks the ray's box test admits, a pre-test for each pair of
        # the groups it admits and a pair test for each pair it crosses,
        # then the crossed pairs in the tau pass, the Newton steps and the
        # albedo pass; K5: the same tests of the NEE segments.  The sweep
        # bounds charge a pair test for every pair instead.
        ray_bytes = (table10k.numel() + lights10k.numel()
                     + boxes10k.numel()) * 4
        evals = int(crossed.sum()) * (SOLVER_ITERS + 2) * CROSSED_EVAL_FLOPS
        sweep_flops = RAYS * table10k.shape[0] * PAIR_TEST_FLOPS
        k4_bytes = ray_bytes + RAYS * (3 + 3 + 5 + 16) * 4
        k5_bytes = ray_bytes + RAYS * (12 + 3) * 4

        def cull_flops(st):
            return (BOX_TEST_FLOPS * (RAYS * n_c + 8 * int(st["admitted"]
                                                           .sum()))
                    + PRE_TEST_FLOPS * pb.GROUP * int(st["groups"].sum())
                    + PAIR_TEST_FLOPS * int(st["crossed"].sum()))

        bounds["big_stage1" + key] = bound(cull_flops(st4) + evals, k4_bytes)
        bounds["big_nee" + key] = bound(cull_flops(st5), k5_bytes)
        bounds["big_stage1_sweep" + key] = bound(sweep_flops + evals,
                                                 k4_bytes)
        bounds["big_nee_sweep" + key] = bound(sweep_flops, k5_bytes)
        log("13 big timing", f"{label}, {RAYS} lanes of chunk "
            f"{BIG_CHUNK_INDEX} of {GRID_SIZE}^2: K4 kernel {fmt_ms(k4_t)}, "
            f"plain {p4_ms:.3f} ms; K5 kernel {fmt_ms(k5_t)}, plain "
            f"{p5_ms:.3f} ms; K4 chunks admitted per ray "
            f"{mean(st4['admitted']):.2f}, holding a crossed pair "
            f"{mean(st4['hit']):.2f} of {n_c}, groups per ray "
            f"{mean(st4['groups']):.2f}; K5 chunks per ray "
            f"{mean(st5['admitted']):.2f}, groups per ray "
            f"{mean(st5['groups']):.2f}; pairs a ray crosses: mean "
            f"{mean(crossed):.2f}, max {int(crossed.max())}, rays over 32 "
            f"{mean(crossed > 32):.5f} and over 64 {mean(crossed > 64):.5f} "
            f"(MAX_HITS {pb.MAX_HITS}); bounds K4 "
            f"{bounds['big_stage1' + key][0]:.4f} ms (sweep "
            f"{bounds['big_stage1_sweep' + key][0]:.4f}), K5 "
            f"{bounds['big_nee' + key][0]:.4f} ms (sweep "
            f"{bounds['big_nee_sweep' + key][0]:.4f}); kernel vs plain "
            f"{json.dumps(res)} ({smi})")
        if not res["ok"]:
            raise AssertionError(f"K4/K5 {label} at the main path's shapes "
                                 f"miss BIG_BARS: {res}")
        k4_err = max(k4_err, res["max_dtau"])
        k5_err = max(k5_err, res["max_dli"])

    # ---- 14: the big-N main path through the CLI, against phase 11 ----
    stats, wall, launches_b, img_big = cli_render(
        text10k, GRID_SIZE, GRID_SPP,
        ["big_stage1", "big_nee", "wave_pre", "wave_post"], engine="dense")
    m_big, m_grid = float(img_big.mean()), float(img_grid.mean())
    log("14 big main", f"cli render {GRID_N} Gaussians {GRID_SIZE}^2 spp "
        f"{GRID_SPP} --engine dense ({stats['kernel']} kernel): render "
        f"{stats['seconds']:.3f} s ({wall:.3f} s with load and PPM), "
        f"{stats['paths'] / stats['seconds'] / 1e6:.3f} Mpaths/s, "
        f"{stats['iterations']} iterations in {stats['chunks']} chunks, "
        f"{stats['bounce_evals']} bounce evaluations, image mean "
        f"{m_big:.6f} vs the grid engine's {m_grid:.6f} (rel "
        f"{abs(m_big - m_grid) / m_grid:.2e}, bar 1e-2), launches "
        f"{json.dumps(launches_b)} ({smi})")
    if stats["kernel"] != "big" or abs(m_big - m_grid) > 0.01 * m_grid:
        raise AssertionError("the big-N render misses the grid's mean")

    # ---- 15: engine auto falls back to K4/K5 where the grid refuses ----
    stats, wall, launches_f, img = cli_render(text_fb, 128, 4,
                                              ["big_stage1", "big_nee"])
    log("15 auto fallback", f"{FALLBACK['n']} Gaussians of diameter 2-4, "
        f"128^2 spp 4, engine auto: engine {stats['engine']} "
        f"({stats['kernel']} kernel), host grid build (refused by "
        f"S_CAP_MAX) {stats['grid_seconds']:.3f} s, render "
        f"{stats['seconds']:.3f} s, "
        f"{stats['paths'] / stats['seconds'] / 1e6:.4f} Mpaths/s, "
        f"{stats['iterations']} iterations, image mean {img.mean():.6f}, "
        f"launches {json.dumps(launches_f)} ({smi})")
    if (stats["engine"], stats["kernel"]) != ("dense", "big"):
        raise AssertionError(f"engine auto took {stats['engine']} "
                             f"({stats['kernel']}), not the big-N fallback")

    # ---- 16: the dense XLA engine, the solvers the kernels do not have ----
    stats, wall, _, img_k1 = cli_render(text250, XLA_SIZE, XLA_SPP,
                                        ["mega_call"])
    m_k1 = float(img_k1.mean())
    log("16 xla engine", f"reference: cli render 250 Gaussians {XLA_SIZE}^2 "
        f"spp {XLA_SPP} --solver analytic_newton ({stats['kernel']} "
        f"kernel) {stats['seconds']:.3f} s, image mean {m_k1:.6f}")
    launches_x = {}
    for solver in XLA_SOLVERS:
        stats, wall, launches_p, img = cli_render(
            text250, XLA_SIZE, XLA_SPP, ["wave_pre", "wave_post"],
            args=["--solver", solver])
        m = float(img.mean())
        launches_x[solver] = launches_p["wave_pre"]
        log("16 xla engine", f"cli render 250 Gaussians {XLA_SIZE}^2 spp "
            f"{XLA_SPP} --solver {solver}: engine {stats['engine']} "
            f"({stats['kernel']} kernel), render {stats['seconds']:.3f} s "
            f"({wall:.3f} s with load and PPM), "
            f"{stats['paths'] / stats['seconds'] / 1e6:.3f} Mpaths/s, "
            f"{stats['iterations']} iterations in {stats['chunks']} chunks "
            f"of {stats['chunk']}, {stats['bounce_evals']} bounce "
            f"evaluations, image mean {m:.6f} vs the megakernel's "
            f"{m_k1:.6f} (rel {abs(m - m_k1) / m_k1:.2e}, bar 1e-2), "
            f"launches {json.dumps(launches_p)} ({smi})")
        # UNIFORM samples the critical segment uniformly, a biased
        # estimator (distance_solvers.h:132-137; the JAX package's
        # test_solver_choice_does_not_change_image leaves it out), so
        # its mean is reported, and its correctness is phase 17's
        if (stats["engine"], stats["kernel"]) != ("dense", "xla") \
                or launches_p["mega_call"] or (
                    solver != "uniform" and abs(m - m_k1) > 0.01 * m_k1):
            raise AssertionError(f"--solver {solver}: not the XLA engine, "
                                 f"K1 launched, or the mean is off")
    stats, wall, launches_p, img = cli_render(
        text10k, XLA_BIG[1], XLA_BIG[2], ["wave_pre", "wave_post"],
        args=["--solver", "bisection"])
    launches_x["10k"] = launches_p["wave_pre"]
    log("16 xla engine", f"cli render {XLA_BIG[0]} Gaussians {XLA_BIG[1]}^2 "
        f"spp {XLA_BIG[2]} --solver bisection, engine auto: engine "
        f"{stats['engine']} ({stats['kernel']} kernel), chunk "
        f"{stats['chunk']} ([chunk, N] = {stats['chunk'] * XLA_BIG[0]} "
        f"elements, budget {1 << 25}), render {stats['seconds']:.3f} s, "
        f"{stats['paths'] / stats['seconds'] / 1e6:.4f} Mpaths/s, "
        f"{stats['iterations']} iterations in {stats['chunks']} chunks, "
        f"image mean {img.mean():.6f}, launches {json.dumps(launches_p)} "
        f"({smi})")
    if stats["kernel"] != "xla" or launches_p["mega_call"] \
            or stats["chunk"] * XLA_BIG[0] > 1 << 25:
        raise AssertionError("the 10k scene's bisection render did not take "
                             "the XLA engine within the element budget")

    # ---- 17: each new path on the card against the CPU ----
    for label, args, spp, kernels in SLICE_PATHS:
        stats, wall, launches_p, card = cli_render(
            text250, CARD_CPU_SIZE, spp, kernels, args=args)
        stats_cpu, wall_cpu, _, cpu = cli_image(text250, CARD_CPU_SIZE, spp,
                                                "cpu", args)
        res = testing.card_cpu_agreement(card, cpu,
                                         hitmask=label == "hitmask")
        log("17 card vs cpu", f"{label} 250 Gaussians {CARD_CPU_SIZE}^2 spp "
            f"{spp}: card {stats['seconds']:.3f} s, cpu "
            f"{stats_cpu['seconds']:.3f} s, {json.dumps(res)} (bars "
            f"{json.dumps(testing.CARD_CPU_BARS)}), launches "
            f"{json.dumps({k: v for k, v in launches_p.items() if v})}")
        if not res["ok"]:
            raise AssertionError(f"{label}: the card's image misses the "
                                 f"CPU's: {res}")

    # ---- 18: the integrators at size ----
    launches_i, images_i = {}, {}
    for label, size, spp, args, kernels in AT_SIZE:
        stats, wall, launches_p, img = cli_render(
            text250, size, spp, kernels, args=args)
        launches_i[label] = {k: v for k, v in launches_p.items() if v}
        images_i[label] = img
        log("18 at size", f"{label} 250 Gaussians {size}^2 spp {spp} "
            f"{' '.join(args[2:])}: render {stats['seconds']:.3f} s "
            f"({wall:.3f} s with load and PPM), chunk {stats['chunk']}, "
            + "".join(f"{k} {stats[k]}, " for k in (
                "paths", "k3_launches", "n_steps", "steps", "shadow_steps",
                "chunks") if k in stats)
            + f"image mean {img.mean():.6f}, launches "
            f"{json.dumps(launches_i[label])} ({smi})")

    # ---- 19: the inverse renderer, card against CPU ----
    from gvr_tpu_torch.integrators.multiscatter import \
        multiscatter_radiance_diff
    from gvr_tpu_torch.inverse.fit import _pixel_rays, fit_loss

    k3 = (rng.planes_uniforms, rng.planes_uniforms_reference,
          rng.wave_uniforms, rng.wave_uniforms_reference)
    text10 = random_gaussian_scene(10, seed=2, diameter=(0.2, 0.7))
    params10 = parse_gmm(text10).medium.pack_parameters()

    def fit_inputs(device, size):
        cam = PinholeCamera.create([0, 1, 6], [0, 1, 0], 0.25 * math.pi,
                                   device=device)
        return (parse_gmm(text10, device=device),) + _pixel_rays(
            cam, size, size, torch.arange(size * size, dtype=torch.int32,
                                          device=device))

    def counted(fn):
        """(fn(), launches of K3 and its plain versions during it)."""
        for c in k3:
            c.launches = 0
        out = fn()
        torch.cuda.synchronize()
        return out, {c.__name__: c.launches for c in k3}

    for loss in ("l2", "l2_dual"):
        res = {}
        for device in ("cpu", dev):
            sc10, o, d, ids = fit_inputs(device, 16)
            p = params10.to(device, copy=True).requires_grad_(True)

            def run():
                val = fit_loss(p, sc10, o, d, ids,
                               torch.full((256, 3), 0.4, device=device),
                               n_bounces=2, spp=2, loss=loss, seed=5)
                val.backward()
                return val

            t0 = time.perf_counter()
            val, launches_l = counted(run)
            res[str(device)] = (val, p.grad, launches_l,
                                time.perf_counter() - t0)
        card, cpu = res[str(dev)], res["cpu"]
        agree = testing.fit_agreement(card[0], card[1], cpu[0], cpu[1])
        want = {"planes_uniforms": 4 if loss == "l2_dual" else 2}
        log("19 fit card vs cpu", f"fit_loss {loss} 10 Gaussians 16^2 2 "
            f"bounces spp 2: card {card[3]:.3f} s, cpu {cpu[3]:.3f} s, "
            f"{json.dumps(agree)} (bars {json.dumps(testing.FIT_BARS)}), "
            f"launches {json.dumps(card[2])}")
        if not agree["ok"] or {k: v for k, v in card[2].items() if v} != want:
            raise AssertionError(f"fit_loss {loss}: the card misses the CPU "
                                 f"or K3 launched other than {want}")
    imgs = {}
    for device in ("cpu", dev):
        sc10, o, d, ids = fit_inputs(device, 32)
        img, launches_r = counted(lambda: multiscatter_radiance_diff(
            sc10, o, d, ids, None, n_bounces=4, sample=3, seed=9,
            rr_after=2))
        imgs[str(device)] = img.cpu().numpy().reshape(32, 32, 3)
    res = testing.card_cpu_agreement(imgs[str(dev)], imgs["cpu"])
    log("19 fit card vs cpu", f"multiscatter_radiance_diff 32^2 4 bounces "
        f"RR from 2: {json.dumps(res)}, launches {json.dumps(launches_r)}")
    if not res["ok"] or launches_r != {"planes_uniforms": 1,
                                       "planes_uniforms_reference": 0,
                                       "wave_uniforms": 0,
                                       "wave_uniforms_reference": 0}:
        raise AssertionError("multiscatter_radiance_diff: the card misses "
                             "the CPU, or K3 did not draw it alone")
    sc10, o, d, _ = fit_inputs(dev, 16)
    res = testing.solve_fd_agreement(sc10, o, d, torch.from_numpy(
        np.random.default_rng(1).uniform(size=256).astype(np.float32))
        .to(dev))
    log("19 fit card vs cpu", f"solve_conditional_free_flight VJP vs "
        f"central differences on the card: {json.dumps(res)} (bars "
        f"{json.dumps(testing.SOLVE_FD_BARS)})")
    if not res["ok"]:
        raise AssertionError("the conditional solve's VJP misses central "
                             "differences on the card")

    # ---- 20: cli fit at the CLI's settings on the 250-Gaussian scene ----
    from gvr_tpu_torch.scene.gaussians import GaussianMixture
    from gvr_tpu_torch.utils.image import psnr

    with tempfile.TemporaryDirectory() as tmp:
        paths = {k: os.path.join(tmp, k) for k in (
            "true.txt", "init.txt", "target.ppm", "init.ppm", "fit")}
        with open(paths["true.txt"], "w") as f:
            f.write(text250)
        sc_true = parse_gmm(text250)
        p = sc_true.medium.pack_parameters().numpy()
        p = p + np.random.default_rng(7).normal(0, 0.1, p.shape) \
            .astype(np.float32)
        with open(paths["init.txt"], "w") as f:
            f.write(testing.scene_text(sc_true.with_medium(
                GaussianMixture.from_parameters(torch.from_numpy(p)))))
        size = str(FIT_SIZE)
        for scene_file, out in (("true.txt", "target.ppm"),
                                ("init.txt", "init.ppm")):
            cli.main(["render", paths[scene_file], "-o", paths[out],
                      "--width", size, "--height", size, "--spp",
                      str(FIT_FINAL_SPP)])
        for fn in counters:
            fn.launches = 0
        torch.cuda.reset_peak_memory_stats()
        fit = cli.main(["fit", paths["init.txt"], "--target",
                        paths["target.ppm"], "-o", paths["fit"], "--iters",
                        str(FIT_ITERS), "--save-every", "20", "--snapshots"])
        launches_fit = {fn.__name__: fn.launches for fn in counters}
        peak_gb = torch.cuda.max_memory_allocated() / 2**30
        target = read_ppm(paths["target.ppm"])
        db_init = psnr(read_ppm(paths["init.ppm"]), target)
        db_fit = psnr(read_ppm(os.path.join(paths["fit"], "final.ppm")),
                      target)
        snaps = [os.path.join(paths["fit"], f"iter_{i:04d}.ppm")
                 for i in (0, 20)]
        written = all(os.path.exists(x) for x in snaps)
    s_it = fit["seconds"] / FIT_ITERS
    bounces_it = FIT_BATCH * 2 * FIT_SPP * FIT_BOUNCES
    log("20 fit main", f"cli fit 250 Gaussians {size}^2, {FIT_ITERS} "
        f"iterations, batch {FIT_BATCH}, {FIT_BOUNCES} bounces, spp "
        f"{FIT_SPP}, lr 1e-2: {fit['seconds']:.3f} s, {s_it:.4f} "
        f"s/iteration, {bounces_it / s_it / 1e6:.4f} M differentiable "
        f"path-bounces/s, losses {json.dumps(fit['losses'])}, PSNR vs "
        f"the target at spp {FIT_FINAL_SPP}: initial {db_init:.3f} dB, "
        f"fitted {db_fit:.3f} dB ({db_fit - db_init:+.3f} dB), peak "
        f"device memory {peak_gb:.3f} GiB, launches "
        f"{json.dumps({k: v for k, v in launches_fit.items() if v})} "
        f"({smi})")
    plain = {k: v for k, v in launches_fit.items()
             if k.endswith("_reference") and v}
    if not (all(np.isfinite(v) for _, v in fit["losses"])
            and len(fit["losses"]) == 2 and np.isfinite(fit["params"]).all()
            and written and fit["paths"][-1].endswith("final.ppm")):
        raise AssertionError("cli fit: a loss or parameter is not finite, "
                             "or an image was not written")
    if launches_fit["planes_uniforms"] != 2 * FIT_SPP * FIT_ITERS \
            or launches_fit["wave_uniforms"] or not \
            launches_fit["mega_call"] or plain:
        raise AssertionError(f"cli fit launched {launches_fit}")
    if not db_fit > db_init:
        raise AssertionError(f"the fitted render ({db_fit:.3f} dB) is no "
                             f"closer to the target than the initial one "
                             f"({db_init:.3f} dB)")

    launches_m, launches_a = media_phases(
        dev, smi, text250, counters, cli_render, cli_image,
        images_i["pureraymarch"])
    parallel_phases(dev, smi, {"250": text250, "10k": text10k, "10": text10},
                    params10, main_img)
    step = step_phase(dev, smi, text250, counters, main_img)
    times["bounce_step"] = (step["full"]["t"], step["full"]["plain_ms"])
    bounds["bounce_step"] = step["full"]["bound"]
    for name, (t, p_ms, bnd) in glue_phase(dev, smi).items():
        times[name], bounds[name] = (t, p_ms), bnd

    def entry(name, replaces, key, path_launches, launches_key, err):
        t = times[key][0]
        return {"name": name, "route": "cuda", "source": KERNEL_SOURCE,
                "replaces": replaces,
                "launches": path_launches[launches_key],
                "max_abs_err": err, "ms": t["ms"], "events_ms": t["events_ms"],
                "dispatch_us": t["dispatch_us"], "recorded": t["recorded"],
                "plain_ms": times[key][1],
                "bound_ms": bounds[key][0], "bound_by": bounds[key][1],
                "library_ms": None}

    kernels = [
        entry("mega", "gvr_tpu/kernels/megatrace.py:501",
              f"mega_spp{MAIN_SPP}", launches, "mega_call",
              chunk_res[MAIN_SPP]["max_diff"]),
        entry("bounce", "gvr_tpu/kernels/pathtrace.py:465", "bounce_step",
              step, "launches", max(k2_err, step["err"])),
        entry("rng", "gvr_tpu/kernels/rng.py:86", "rng", launches_g,
              "wave_uniforms", 0.0),
        entry("span_tau", "gvr_tpu/kernels/gridtrace.py:217", "span_tau",
              launches_g, "span_tau_pass", k6_err),
        entry("grid_solve", "gvr_tpu/kernels/gridtrace.py:425",
              "grid_solve", launches_g, "solve_pass", k7_err),
        entry("big_stage1", "gvr_tpu/kernels/pathtrace_big.py:384",
              "big_stage1", launches_b, "big_stage1", k4_err),
        entry("big_nee", "gvr_tpu/kernels/pathtrace_big.py:409", "big_nee",
              launches_b, "big_nee", k5_err),
        entry("wave_pre", None, "wave_pre", launches_b, "wave_pre", 0.0),
        entry("wave_post", None, "wave_post", launches_b, "wave_post", 0.0),
    ]
    # K1 shares K2's device functions (the pair sweep, the solve, the
    # shadow-ray depth) but not its bounce, which runs on the step path
    # (phase 28): K2's launches, device ms, plain ms and bound are that
    # path's, at the first iteration of the headline's chunk 9 (65,536
    # lanes), its tail iteration's in *_tail and phase 5's 65,536 random
    # rays' in *_random; its bound counts the pairs the rays cross, as
    # K1's does, and bound_ms_sweep* a pair test of every row.  K3 also
    # runs inside K1 and K8, and the grid main path launches it directly,
    # once an iteration, as wave_uniforms (its count is that run's)
    kernels[1]["inside"] = kernels[2]["inside"] = "mega"
    kernels[1]["path"] = "step"
    kernels[1].update(
        lanes_tail=step["tail"]["lanes"], ms_tail=step["tail"]["t"]["ms"],
        plain_ms_tail=step["tail"]["plain_ms"],
        bound_ms_tail=step["tail"]["bound"][0],
        ms_random=times["bounce"][0]["ms"],
        plain_ms_random=times["bounce"][1],
        bound_ms_random=bounds["bounce"][0],
        bound_ms_sweep=step["full"]["bound_sweep"][0],
        bound_ms_sweep_tail=step["tail"]["bound_sweep"][0],
        bound_ms_sweep_random=bounds["bounce_sweep"][0],
        idle_share_step=step["profile"]["idle_share"],
        device_share_step=step["profile"]["k2_share"])
    # this slice's paths draw through K3 too: single scatter twice a
    # (chunk, sample) and the marchers once a step (planes_uniforms, phase
    # 18); the dense wavefronts (big-N, step, XLA) draw inside K8
    kernels[2]["launches_integrators"] = launches_i
    # the fit path (phase 20): K3 four times an iteration
    # (planes_uniforms: 2 loss buffers x spp 2, every bounce's draws in
    # one launch), K1 for the snapshots and the final render
    kernels[0]["launches_fit"] = launches_fit["mega_call"]
    kernels[2]["launches_fit"] = launches_fit["planes_uniforms"]
    # the media marchers (phases 21-22) draw once a march step
    # (planes_uniforms), the turntables (phase 23) through K1 or K3
    kernels[0]["launches_animate"] = {
        k: v.get("mega_call", 0) for k, v in launches_a.items()}
    kernels[2]["launches_media"] = launches_m
    kernels[2]["launches_animate"] = {
        k: v.get("planes_uniforms", 0) for k, v in launches_a.items()}
    kernels[2]["ms_planes"] = times["rng_planes"][0]["ms"]
    kernels[2]["bound_ms_planes"] = bounds["rng_planes"][0]
    for k in kernels[2:5]:
        k["path"] = "grid"
    # K8 replaces no TPU kernel: the dense wavefronts' eager glue (phase
    # 29); its launches are the big-N render's (phase 14), the XLA
    # engine's in launches_xla (phase 16)
    for k in kernels[7:]:
        k["path"] = "big"
        k["launches_xla"] = launches_x
    for k in kernels[5:7]:
        k["path"] = "big"
        t, k["plain_ms_bounce1"] = times[k["name"] + "_bounce1"]
        k["ms_bounce1"] = t["ms"]
        k["bound_ms_bounce1"] = bounds[k["name"] + "_bounce1"][0]
        k["bound_ms_sweep"] = bounds[k["name"] + "_sweep"][0]
        k["bound_ms_sweep_bounce1"] = bounds[k["name"] + "_sweep_bounce1"][0]
    kernels[0]["ms_spp4"] = times["mega_spp4"][0]["ms"]
    kernels[0]["plain_ms_spp4"] = times["mega_spp4"][1]
    kernels[0]["bound_ms_pretest"] = bounds["mega_pretest"][0]
    kernels[0]["bound_ms_sweep"] = bounds["mega_sweep"][0]
    kernels[3]["bound_ms_sweep"] = bounds["span_tau_sweep"][0]
    kernels[4]["bound_ms_sweep"] = bounds["grid_solve_sweep"][0]
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    sys.exit(main())
