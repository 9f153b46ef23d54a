"""Rank programs that check the parallel layer, for ``launch.spawn``.

``cpu_suite`` is the rank program of ``tests/test_torch_parallel.py``:
eight gloo ranks on the CPU run the data-parallel renders and gradient
over sub-meshes of 2, 4 and 8 ranks and the tensor-parallel paths over
the (1 x 8), (2 x 4) and (4 x 2) meshes, and return numpy results that
the test holds against the one-process port and the JAX package.
``card_suite`` is that of the card tests (``tests/test_torch_cuda.py``):
two gloo ranks that share one card run the data-parallel renders of the
main path's engines, the tensor-parallel render and gradient, and the
data-parallel fit.  Scenes arrive as numpy arrays (``scene/convert``), so
every rank and the caller's reference start from the same bits.  A
failed case is returned as its traceback, so the other cases still
report.
"""

from __future__ import annotations

import math
import os
import tempfile
import traceback

import numpy as np
import torch
import torch.distributed as dist

from gvr_tpu_torch.cameras import PinholeCamera
from gvr_tpu_torch.config import FitConfig, RenderConfig, Solver
from gvr_tpu_torch.ops import gaxis
from gvr_tpu_torch.parallel.gauss_sharded import (
    GAUSS_AXIS, fit_value_and_grad_tp, gather_gauss, gauss_rows,
    make_mesh_2d, pad_mixture, render_multiscatter_tp, render_rays_tp)
from gvr_tpu_torch.parallel.sharding import (make_mesh, shard_last_arg,
                                             sharded_render_fn,
                                             sharded_value_and_grad)
from gvr_tpu_torch.scene.convert import params_from_numpy, scene_from_numpy

# the data-parallel renders of the CPU suite: name -> (scene, config);
# 'mega' is the production path (K1's plain version on the CPU), 'step'
# the step wavefront (K2's), 'xla' the dense XLA engine, 'grid' the grid
# wavefront, 'awkward' a ray_chunk that no shard count divides
DP_RENDERS = {
    "mega": ("scene1", dict(width=16, height=16, spp=2)),
    "step": ("scene1", dict(width=16, height=16, spp=2, wavefront="step")),
    "awkward": ("scene1", dict(width=16, height=16, spp=2, ray_chunk=300)),
    "xla": ("scene1", dict(width=16, height=16, spp=2,
                           solver=Solver.BISECTION)),
    "grid": ("scene24", dict(width=8, height=8, spp=1, engine="grid")),
}
DP_SHARDS = (2, 4)
DP_GRAD_SHARDS = (4, 8)
TP_SHAPES = ((1, 8), (2, 4), (4, 2))
TP_RAYS = dict(width=16, height=16, spp=1, max_bounces=3)
TP_IMAGE = dict(width=12, height=12, spp=2, max_bounces=3)
TP_UNIFORM = dict(width=16, height=16, spp=1, max_bounces=2,
                  solver=Solver.UNIFORM)
ADAM_LR, ADAM_STEPS = 5e-2, 3


def camera(device="cpu") -> PinholeCamera:
    return PinholeCamera.create([0, 1, 6], [0, 1, 0], 0.25 * math.pi,
                                device=device)


def pixel_rays(w: int, h: int, device="cpu"):
    """(o, d, ids) through the centres of all w x h pixels."""
    from gvr_tpu_torch.inverse.fit import _pixel_rays
    return _pixel_rays(camera(device), w, h,
                       torch.arange(w * h, dtype=torch.int32, device=device))


def _case(out: dict, name: str, fn) -> None:
    try:
        out[name] = fn()
    except Exception:
        out[name] = {"error": traceback.format_exc()}


def _host(x):
    return x.detach().cpu().numpy()


def cpu_suite(dev, inp: dict) -> dict:
    """The CPU tests' cases on one rank of an 8-rank job; ``inp`` holds
    the scenes' arrays ('scene1', 'scene24', 'scene37', 'scene40',
    'scene8'), the JAX package's packed parameter vectors ('params1',
    'params8') and, under 'cli', a scene file, a target image, a
    directory and the render's and fit's arguments.  Returns {case:
    result}."""
    from gvr_tpu_torch.integrators.multiscatter import (
        multiscatter_radiance, render_multiscatter, tile_ids,
        wavefront_pixels_xla)
    from gvr_tpu_torch.inverse.fit import fit_loss
    from gvr_tpu_torch.ops.transmittance import (far_bound, sigma_t_at,
                                                 tau_coeffs, tau_total,
                                                 tau_up_to)

    rank = dist.get_rank()
    sc = {k: scene_from_numpy(v, dev) for k, v in inp.items()
          if k.startswith("scene")}
    out = {}
    o, d, ids = pixel_rays(16, 16, dev)

    # ---- data parallel: renders over 2 and 4 ranks, gradients over 4, 8
    for k in DP_SHARDS:
        mesh = make_mesh(range(k))
        if rank >= k:
            continue
        cfg = RenderConfig(width=16, height=16, spp=1)
        fn = sharded_render_fn(
            lambda s, *rays: multiscatter_radiance(s, *rays, cfg), mesh)
        _case(out, f"dp_render_fn_{k}",
              lambda: _host(fn(sc["scene1"], o, d, ids)))
        xla = RenderConfig(**DP_RENDERS["xla"][1])
        last = shard_last_arg(
            lambda s, cam, i: wavefront_pixels_xla(s, cam, xla, i), mesh, 3)
        _case(out, f"dp_last_arg_{k}", lambda: _host(last(
            sc["scene1"], camera(dev), tile_ids(16, 16, dev))))
        for name, (key, kw) in DP_RENDERS.items():
            st = {}
            _case(out, f"dp_{name}_{k}", lambda: render_multiscatter(
                sc[key], camera(dev), RenderConfig(**kw), device=dev,
                stats=st, mesh=mesh))
            out[f"dp_{name}_{k}_stats"] = dict(st)
    target = torch.full((256, 3), 0.3)
    for k in DP_GRAD_SHARDS:
        mesh = make_mesh(range(k))
        if rank >= k:
            continue
        vg = sharded_value_and_grad(
            lambda p, t, *a: fit_loss(p, t, *a, n_bounces=2), mesh)
        _case(out, f"dp_grad_{k}", lambda: tuple(_host(x) for x in vg(
            params_from_numpy(inp["params1"]), sc["scene1"], o, d, ids,
            target)))

    # ---- tensor parallel over the gauss axis
    meshes = {shape: make_mesh_2d(*shape) for shape in TP_SHAPES}

    def reductions():
        mesh = meshes[(1, 8)]
        gmm = gauss_rows(pad_mixture(sc["scene40"].medium, 8), mesh)
        with gaxis.gaussian_axis(mesh.group(GAUSS_AXIS)):
            rg = tau_coeffs(gmm, o, d)
            t = torch.full(o.shape[:1], 5.0)
            return tuple(_host(x) for x in (
                tau_total(rg), tau_up_to(rg, t), sigma_t_at(rg, t),
                far_bound(rg)))

    _case(out, "tp_reductions", reductions)
    for shape, mesh in meshes.items():
        _case(out, f"tp_rays_{shape[0]}x{shape[1]}", lambda: _host(
            render_rays_tp(sc["scene40"], o, d, ids,
                           RenderConfig(**TP_RAYS), mesh)))
    mesh = meshes[(2, 4)]
    _case(out, "tp_pad", lambda: _host(render_rays_tp(
        sc["scene37"], o, d, ids, RenderConfig(**TP_RAYS), mesh)))
    _case(out, "tp_image", lambda: _host(render_multiscatter_tp(
        sc["scene40"], camera(dev), RenderConfig(**TP_IMAGE), mesh)))
    _case(out, "tp_uniform", lambda: _host(render_rays_tp(
        sc["scene40"], o, d, ids, RenderConfig(**TP_UNIFORM), mesh)))

    s8 = sc["scene8"]
    o8, d8, ids8 = pixel_rays(8, 8, dev)
    tgt8 = torch.full((64, 3), 0.4)
    f = fit_value_and_grad_tp(mesh, n_bounces=2)

    def tp_fit():
        val, grad = f(params_from_numpy(inp["params8"]), s8.lights_p,
                      s8.lights_i, s8.env_color, o8, d8, ids8, tgt8, 0)
        return _host(val), _host(gather_gauss(grad, mesh))

    def tp_adam():
        # each rank steps Adam on its own slice of the parameters
        p = params_from_numpy(inp["params8"])
        per = p.shape[0] // mesh.shape[GAUSS_AXIS]
        j = mesh.index(GAUSS_AXIS)
        local = p[j * per:(j + 1) * per].clone().requires_grad_(True)
        opt = torch.optim.Adam([local], lr=ADAM_LR)
        losses = []
        for it in range(ADAM_STEPS):
            val, local.grad = f(p, s8.lights_p, s8.lights_i, s8.env_color,
                                o8, d8, ids8, tgt8, it)
            opt.step()
            p = gather_gauss(local.detach(), mesh)
            losses.append(float(val))
        return np.asarray(losses), _host(p)

    _case(out, "tp_fit", tp_fit)
    _case(out, "tp_adam", tp_adam)

    # ---- the CLI in a job of 8 ranks: render and fit on every rank, each
    # rank naming its own outputs, so the caller sees which ranks wrote
    if "cli" in inp:
        from gvr_tpu_torch import cli
        c = inp["cli"]
        _case(out, "cli_render", lambda: dict(cli.main(
            ["render", c["scene"], "-o", f"{c['dir']}/render_r{rank}.ppm",
             "--device", "cpu", "--stats"] + c["render"])))
        _case(out, "cli_fit", lambda: cli.main(
            ["fit", c["scene"], "--target", c["target"], "-o",
             f"{c['dir']}/fit_r{rank}", "--device", "cpu"] + c["fit"]))
    return out


def counted_kernels():
    """The kernel wrappers and plain versions that count their calls."""
    from gvr_tpu_torch.kernels import (gridtrace, megatrace, pathtrace,
                                       pathtrace_big, rng, wavefront)
    return (rng.planes_uniforms, rng.planes_uniforms_reference,
            rng.wave_uniforms, rng.wave_uniforms_reference,
            wavefront.wave_pre, wavefront.wave_pre_reference,
            wavefront.wave_post, wavefront.wave_post_reference,
            pathtrace.bounce_step, pathtrace.bounce_core_reference,
            megatrace.mega_call, megatrace.mega_reference,
            gridtrace.span_tau_pass, gridtrace.span_tau_reference,
            gridtrace.solve_pass, gridtrace.solve_reference,
            pathtrace_big.big_stage1, pathtrace_big.big_stage1_reference,
            pathtrace_big.big_nee, pathtrace_big.big_nee_reference)


def card_suite(dev, inp: dict) -> dict:
    """The card tests' parallel cases on one rank of a 2-rank gloo job on
    one card (NCCL refuses ranks that share a card).

    'dp': each of ``inp['dp']`` (label, scene arrays, RenderConfig
    fields) rendered by ``render_multiscatter`` over both ranks, with its
    stats and this rank's kernel launches (``counted_kernels``, every
    count set to 0 just before); rank 0 also returns the image.  'tp':
    ``render_multiscatter_tp`` of ``inp['tp_scene']`` at ``inp['tp_cfg']``
    (rank 0 returns the image) and ``fit_value_and_grad_tp`` on
    ``inp['fit_params']`` and 16^2 pixel rays (loss and gathered
    gradient), both over a (1 x 2) mesh.  'fit': ``logged_fit`` over both
    ranks from ``inp['fit_init']`` toward ``inp['fit_target']`` for
    ``inp['fit_iters']`` iterations of ``inp['fit_batch']`` pixels."""
    from gvr_tpu_torch.integrators.multiscatter import render_multiscatter

    rank = dist.get_rank()
    counters = counted_kernels()
    out = {"dp": {}}
    for label, arrays, kw in inp["dp"]:
        sc = scene_from_numpy(arrays, dev)
        for fn in counters:
            fn.launches = 0
        stats = {}
        img = render_multiscatter(sc, camera(dev), RenderConfig(**kw),
                                  device=dev, stats=stats)
        out["dp"][label] = dict(
            stats=stats, launches={fn.__name__: fn.launches
                                   for fn in counters},
            image=img if rank == 0 else None)

    mesh = make_mesh_2d(1, 2)
    img = render_multiscatter_tp(scene_from_numpy(inp["tp_scene"], dev),
                                 camera(dev), RenderConfig(**inp["tp_cfg"]),
                                 mesh)
    out["tp_render"] = _host(img) if rank == 0 else None
    sc10 = scene_from_numpy(inp["fit_scene"], dev)
    o, d, ids = pixel_rays(16, 16, dev)
    val, grad = fit_value_and_grad_tp(mesh, n_bounces=2)(
        params_from_numpy(inp["fit_params"], dev), sc10.lights_p,
        sc10.lights_i, sc10.env_color, o, d, ids,
        torch.full((256, 3), 0.4, device=dev), inp["fit_seed"])
    out["tp_fit"] = dict(loss=float(val), grad=_host(gather_gauss(grad,
                                                                  mesh)))
    out["fit"] = logged_fit(scene_from_numpy(inp["fit_init"], dev),
                            inp["fit_target"], inp["fit_iters"],
                            inp["fit_batch"], make_mesh())
    return out


def logged_fit(scene, target, iters: int, batch: int, mesh=None) -> dict:
    """``fit_gaussians`` of ``scene`` toward ``target`` for ``iters``
    iterations of ``batch`` pixels, logging every one: the logged losses
    and the packed parameters after each iteration."""
    from gvr_tpu_torch.inverse.fit import fit_gaussians

    dev = scene.env_color.device
    losses, params = [], []

    def log(msg):
        if msg.startswith("[fit] iter"):
            losses.append(float(msg.split()[4]))

    with tempfile.TemporaryDirectory() as tmp:
        fit_gaussians(scene, camera(dev), target,
                      FitConfig(max_iters=iters, save_every=1,
                                out_dir=os.path.join(tmp, "fit")),
                      batch_pixels=batch, mesh=mesh, log=log,
                      save_snapshot=lambda it, sc: params.append(
                          _host(sc.medium.pack_parameters())))
    return dict(losses=losses, params=params)
