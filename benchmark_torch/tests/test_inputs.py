"""The inputs a run makes from its seed: the scene and the renders."""

from __future__ import annotations

import json

import numpy as np
import pytest

from benchmark_torch import reference, scenes, traffic
from conftest import PKG, REPO

SEEDS = [0, 7, 2 ** 31 + 5, 2 ** 40 + 3]


def _config(n=40):
    cfg = json.loads((REPO / PKG / "configs" / "gmm250.json").read_text())
    return dict(cfg, n=n)


def test_every_seed_renders_the_same_gaussians_in_its_own_order():
    texts = [scenes.random_gaussians(_config(), s, "cpu") for s in SEEDS]
    assert texts[0] == scenes.random_gaussians(_config(), SEEDS[0], "cpu")
    rows = [sorted(t.splitlines()) for t in texts]
    assert all(r == rows[0] for r in rows)
    assert len({t for t in texts}) == len(SEEDS)


def test_the_scene_has_the_generators_ranges():
    s = reference.parse_scene(scenes.random_gaussians(_config(2000), 3, "cpu"))
    assert s["mean"].shape == (2000, 3) and s["lights"].shape == (3, 6)
    assert (s["mean"].min(0) >= [-1, 0, -1]).all()
    assert (s["mean"].max(0) <= [1, 2, 1]).all()
    assert 0.2 <= s["density"].min() and s["density"].max() <= 0.5
    assert 0.25 <= s["albedo"].min() and s["albedo"].max() <= 0.95
    sigma = np.sqrt(np.linalg.eigvalsh(s["cov"]))
    assert 0.005 - 1e-4 <= sigma.min() and sigma.max() <= 0.0175 + 1e-4


def test_the_program_parses_what_the_reference_reads():
    from gvr_tpu_torch.scene.scene import parse_gmm
    text = scenes.random_gaussians(_config(600), 11, "cpu")
    prog, ref = parse_gmm(text), reference.parse_scene(text)
    assert prog.medium.n == 600
    assert np.allclose(np.sort(prog.medium.mean.numpy(), axis=0),
                       np.sort(ref["mean"], axis=0), atol=1e-6)


@pytest.mark.parametrize("seed", SEEDS)
def test_render_seeds_and_draws_repeat_and_differ(seed):
    rs = [traffic.render_seed(seed, i) for i in range(50)]
    assert rs == [traffic.render_seed(seed, i) for i in range(50)]
    assert len(set(rs)) == 50 and all(0 <= r < 2 ** 32 for r in rs)
    a = traffic.draw(seed, traffic.PIXELS, 1 << 20, 4096)
    assert (a == traffic.draw(seed, traffic.PIXELS, 1 << 20, 4096)).all()
    assert len(np.unique(a)) == 4096
    assert not (a == traffic.draw(seed, traffic.RENDERS, 1 << 20,
                                  4096)).all()
