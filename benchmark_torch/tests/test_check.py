"""The numbers compared, on made-up pixels, and the reservoir of renders."""

from __future__ import annotations

from collections import Counter

import numpy as np

from benchmark_torch import check


def test_one_far_off_pixel_moves_both():
    ref = np.full((1000, 3), 0.5)
    prog = ref + 1e-6
    prog[7] = [6.0, 1.5, 2.2]
    a = check.agreement(prog, ref)
    assert a["off_frac"] == 1 / 1000
    assert a["mean_diff"] > 2e-3 and a["nonfinite"] == 0


def test_a_share_of_doubled_pixels_moves_both():
    ref = np.full((1000, 3), 0.5)
    prog = ref.copy()
    prog[::16] *= 2.0
    a = check.agreement(prog, ref)
    assert a["off_frac"] == 63 / 1000
    assert a["mean_diff"] == 63 * 0.5 / 1000


def test_one_doubled_pixel_in_a_hundred_fails_a_mean_diff_limit():
    ref = np.full((1000, 3), 0.5)
    prog = ref.copy()
    prog[::100] *= 2.0
    ok, _ = check.judge(check.agreement(prog, ref),
                        dict(off_frac=0.05, mean_diff=3e-3))
    assert not ok


def test_a_nonfinite_pixel_is_off_and_counted():
    ref = np.full((100, 3), 0.5)
    prog = ref.copy()
    prog[3, 1] = np.nan
    a = check.agreement(prog, ref)
    assert a["nonfinite"] == 1 and a["off_frac"] == 0.01
    assert np.isfinite(a["mean_diff"])


def test_no_render_is_not_correct():
    a = check.agreement([], [])
    ok, _ = check.judge(a, dict(off_frac=0.05, mean_diff=1e-3))
    assert a["off_frac"] == 1.0 and not ok


def test_judge_holds_each_limited_number_and_the_exact_ones():
    ok, checks = check.judge(dict(off_frac=0.01, mean_diff=1e-4,
                                  nonfinite=0, failed=0, wrong_kernel=0),
                             dict(off_frac=0.02, mean_diff=1e-3))
    assert ok and set(checks) == {"off_frac", "mean_diff", "nonfinite",
                                  "failed", "wrong_kernel"}
    ok, _ = check.judge(dict(off_frac=0.01, failed=1), dict(off_frac=0.02))
    assert not ok


def test_half_the_checked_pixels_cross_the_medium_where_enough_do():
    medium = np.zeros(400, bool)
    medium[::10] = True
    pos = check.pick_pixels(2 ** 40 + 1, medium, 60)
    assert len(np.unique(pos)) == 60
    assert medium[pos].sum() >= 30
    assert (check.pick_pixels(2 ** 40 + 1, medium, 60) == pos).all()


def _sample(seed, n, k):
    r = check.Reservoir(seed, k)
    for i in range(1, n + 1):
        r.offer(i, f"image {i}")
    return r.kept()


def test_the_reservoir_repeats_with_its_seed_and_keeps_k():
    a = _sample(2 ** 33 + 5, 500, 3)
    assert a == _sample(2 ** 33 + 5, 500, 3)
    assert len(a) == 3 and [i for i, _ in a] == sorted(i for i, _ in a)
    assert all(img == f"image {i}" for i, img in a)
    assert _sample(7, 2, 3) == [(1, "image 1"), (2, "image 2")]


def test_the_reservoir_draws_every_render_alike():
    hits = Counter(i for seed in range(3000)
                   for i, _ in _sample(seed, 10, 2))
    assert set(hits) == set(range(1, 11))
    assert max(hits.values()) < 1.25 * min(hits.values())
