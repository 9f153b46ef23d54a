"""The benchmark's copy of the work count against the program's
``megatrace.mega_reference(counts=)``, and the bound's arithmetic."""

from __future__ import annotations

import json
import math

import pytest
import torch

from benchmark_torch import reference, scenes, work
from conftest import PKG, REPO


@pytest.mark.parametrize("n, size, spp", [(24, 12, 4), (300, 8, 9)])
def test_copied_count_equals_mega_reference(n, size, spp):
    from gvr_tpu_torch.cameras import PinholeCamera
    from gvr_tpu_torch.config import RenderConfig
    from gvr_tpu_torch.kernels import megatrace
    from gvr_tpu_torch.kernels.pathtrace import pack_table
    from gvr_tpu_torch.scene.scene import parse_gmm

    cfg = json.loads((REPO / PKG / "configs" / "gmm250.json").read_text())
    scene = parse_gmm(scenes.random_gaussians(dict(cfg, n=n), 2 ** 32 + 1, "cpu"))
    cam = PinholeCamera.create([0, 1, 6], [0, 1, 0], math.radians(45.0))
    rc = RenderConfig(width=size, height=size, spp=spp, seed=77)
    ids = torch.arange(size * size, dtype=torch.int32)
    table, vec = pack_table(scene.medium), megatrace.camera_vector(cam)
    want = {}
    sums, _ = megatrace.mega_reference(vec, table, ids, rc, scene.lights(),
                                       scene.env_color, True, counts=want)
    got = {}
    cam_d = dict(position=vec[0:3], right=vec[3:6], up=vec[6:9],
                 view_dir=vec[9:12], focal=vec[12])
    rad = reference.render_pixels(table, scene.lights(), scene.env_color,
                                  cam_d, size, size, spp, 77, ids.long(),
                                  counts=got)
    assert got == want
    assert torch.allclose(rad, sums / spp, atol=1e-5, rtol=1e-5)


def test_bound_counts_each_kind_of_work_once():
    w = dict(groups=8, evals=100, scattered=40, ext_pairs=30, solve_pairs=20,
             nee_pairs=10, ext_groups=0, ext_rows=1000, nee_groups=0,
             nee_rows=500)
    want = (19 * 140 * 8 + 56 * 1500 + (94 + 13) * 40 + 13 * 13 * 20)
    assert work.flops(w) == want
    b = work.bound_s(w, scale=4.0, gaussians=250, pixels=64, renders=3)
    assert b["flops"] == want * 4.0 * 3
    assert b["bytes"] == (250 * 64 + 64 * 12) * 3
    assert b["bound_s"] == max(b["flops"] / 67e12, b["bytes"] / 3.35e12)
