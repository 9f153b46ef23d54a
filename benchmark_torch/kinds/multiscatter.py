"""A kind of cell: stills of a generated Gaussian-mixture scene rendered
by ``render_multiscatter`` (what ``cli render`` calls), checked against
``reference.render_pixels``.

A traffic file names its kind (``"kind": "multiscatter"``), and the
harness finds this file by that name; a cell of another kind (a fit, a
marcher, a turntable) is a file of its own beside it, with the same
functions:

* ``setup(cell, seed, device)``: the program's side, ``{"text",
  "render", "build"}``: the scene made on the card
  (``scenes.random_gaussians``), parsed by the program (``parse_gmm``),
  ``render(i, stats)``, render i of the run as an image [H, W, 3] on the
  host, and, on a card, the program's builds that set-up times apart
  ({name: fn}, fn() true where it built rather than loaded);
* ``checked(cell, text, seed, device)``: the pixel ids a run compares,
  drawn from the seed: of ``CANDIDATES`` x ``check_pixels`` candidates,
  half among those whose centre ray crosses the medium (the reference's
  own interval test), half among all, since most pixels of a sparse scene
  see only the environment, which any render gets right;
* ``values(image, ids)``: the program's values at those pixels;
* ``reference_values(cell, text, seed, renders, ids, device, dtype)``: the
  reference's values [len(renders), P, 3] of those pixels of render i for
  each i of ``renders``, in ``dtype`` (float64 decides, the control is a
  precision step below the configuration's), traced on the same paths,
  keyed as the program keys them, with the solve the cell's engine runs
  (``cells/<cell>.json``'s ``reference``, over ``PATH_DEFAULTS``);
* ``work_bound(cell, text, seed, renders, device)``: the work the paths of
  ``renders`` renders need and the least time the card could take for it
  (``work.bound_s``), counted on ``count_pixels`` pixels of render 1.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from benchmark_torch import check, reference, scenes, work
from benchmark_torch.traffic import COUNT, PIXELS, draw, pixels, \
    render_kwargs, render_seed

CANDIDATES = 4           # candidate pixels drawn per pixel checked


def setup(cell, seed: int, device) -> dict:
    from gvr_tpu_torch.cameras import PinholeCamera
    from gvr_tpu_torch.config import RenderConfig
    from gvr_tpu_torch.integrators import multiscatter
    from gvr_tpu_torch.scene.scene import parse_gmm

    cfg, tr = cell.config, cell.traffic
    text = scenes.random_gaussians(cfg, seed, device)
    scene = parse_gmm(text, env_color=tuple(cfg["env_color"]),
                      device=device)
    cam = cfg["camera"]
    camera = PinholeCamera.create(cam["position"], cam["lookat"],
                                  math.radians(cam["fov_deg"]),
                                  device=device)

    def render(i: int, stats: dict):
        rc = RenderConfig(**render_kwargs(tr, seed, i))
        return multiscatter.render_multiscatter(scene, camera, rc,
                                                device=device, stats=stats)

    def build_kernels() -> bool:
        from gvr_tpu_torch.kernels import _build
        built = _build.build()["built"]
        _build.library()
        return built

    return dict(text=text, render=render, build=dict(kernels=build_kernels))


def _inputs(config: dict, text: str, dtype, device) -> dict:
    """The reference's table, lights, environment and camera of the
    scene text, in ``dtype`` on ``device``."""
    scene = reference.parse_scene(text)
    cam = config["camera"]
    as_t = lambda x: torch.as_tensor(np.asarray(x, np.float64),
                                     device=device).to(dtype)
    return dict(table=reference.gaussian_table(scene, dtype, device),
                lights=as_t(scene["lights"]), env=as_t(config["env_color"]),
                cam=reference.pinhole(cam["position"], cam["lookat"],
                                      cam["fov_deg"], dtype, device))


def _medium(inputs: dict, traffic: dict, ids: np.ndarray,
            block: int = 2048) -> np.ndarray:
    """Whether the centre ray of each pixel id crosses some Gaussian's
    R_CUT ellipsoid (the reference's interval test), bool [P]."""
    table, cam = inputs["table"], inputs["cam"]
    w, h = traffic["render"]["width"], traffic["render"]["height"]
    col = lambda f: table[:, f:f + 1]
    out = []
    for start in range(0, len(ids), block):
        pid = torch.as_tensor(ids[start:start + block], device=table.device)
        u = ((pid % w).to(table.dtype) + 0.5) / w
        v = ((pid // w).to(table.dtype) + 0.5) / h
        o, d = reference._camera_rays(cam, u, v)
        ray = [x[:, k][None, :] for x in (o, d) for k in range(3)]
        ok = reference._interval(col, *ray, *reference._coeffs(col, *ray))[3]
        out.append(ok.any(0).cpu().numpy())
    return np.concatenate(out) if out else np.zeros(0, bool)


def _pixels(inputs: dict, traffic: dict, seed: int, ids: np.ndarray,
            path: dict | None, counts=None) -> np.ndarray:
    """[P, 3] float64 mean radiance of pixel ``ids`` of the render whose
    RNG seed is ``seed``, by the reference on ``inputs``."""
    r = traffic["render"]
    out = reference.render_pixels(
        inputs["table"], inputs["lights"], inputs["env"], inputs["cam"],
        r["width"], r["height"], r["spp"], seed,
        torch.as_tensor(ids, dtype=torch.int64,
                        device=inputs["table"].device),
        counts=counts, path=path)
    return out.double().cpu().numpy()


def checked(cell, text: str, seed: int, device) -> np.ndarray:
    tr = cell.traffic
    cand = draw(seed, PIXELS, pixels(tr), CANDIDATES * tr["check_pixels"])
    inputs = _inputs(cell.config, text, torch.float64, device)
    return cand[check.pick_pixels(seed, _medium(inputs, tr, cand),
                                  tr["check_pixels"])]


def values(image, ids: np.ndarray) -> np.ndarray:
    return np.asarray(image).reshape(-1, 3)[ids]


def reference_values(cell, text: str, seed: int, renders, ids, device,
                     dtype=torch.float64) -> np.ndarray:
    inputs = _inputs(cell.config, text, dtype, device)
    return np.stack([_pixels(inputs, cell.traffic, render_seed(seed, i),
                             ids, cell.cell.get("reference"))
                     for i in renders])


def work_bound(cell, text: str, seed: int, renders: int, device) -> dict:
    tr = cell.traffic
    inputs = _inputs(cell.config, text, torch.float32, device)
    n_px = pixels(tr)
    ids = draw(seed, COUNT, n_px, tr["count_pixels"])
    counts = {}
    _pixels(inputs, tr, render_seed(seed, 1), ids,
            cell.cell.get("reference"), counts=counts)
    return dict(work=counts, **work.bound_s(
        counts, n_px / len(ids), cell.config["n"], n_px, renders))
