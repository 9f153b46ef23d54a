"""Whether the timed renders are right: the numbers compared, each beside
its limit, and which renders of a window are checked.

During the window a reservoir (``Reservoir``) keeps a uniform sample of
``check_renders`` of the renders completed, drawn from the seed, as
references to their images: nothing is copied or gathered in the window.
After it the cell's kind (``kinds/<kind>.py``) draws ``check_pixels``
pixels from the seed and renders them again with the plain reference in
float64, and the program's values are compared with them:

* ``off_frac``: the share of the pixels off, a pixel being off where a
  channel differs by more than OFF_ATOL + OFF_RTOL x |reference| (the
  repo's ``testing.OFF_ATOL``/``OFF_RTOL``): a path whose scatter or
  roulette test lies within rounding of its threshold takes the other
  branch in float32, so some pixels are off in a sound run;
* ``mean_diff``: the mean |program - reference| over the pixels and
  channels;
* ``nonfinite``: pixels that are not finite (limit 0);
* ``wrong_kernel``: renders whose ``stats['kernel']`` is not the cell's
  (limit 0);
* ``failed``: renders that raised (limit 0).

A cell compares the numbers that ``cells/<cell>.json`` gives a limit, set
from the program's readings over a dozen seeds and more and the
control's (the reference one precision step below the configuration's,
``CONTROL``, in the program's place), and the exact ones; PERF.md gives
the readings.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark_torch.traffic import RENDERS

OFF_ATOL, OFF_RTOL = 1e-4, 1e-3
EXACT = ("nonfinite", "wrong_kernel", "failed")
# a configuration's stated precision -> its control's
CONTROL = {"float64": torch.float32, "float32": torch.bfloat16}


class Reservoir:
    """A uniform sample of ``k`` of the renders a window completes, drawn
    from ``seed`` as they complete: the n-th takes a slot with
    probability k / n (Algorithm R)."""

    def __init__(self, seed: int, k: int):
        self.rng = np.random.default_rng([seed % (1 << 64), RENDERS])
        self.k, self.n, self.slots = k, 0, {}

    def offer(self, i: int, image) -> None:
        self.n += 1
        slot = self.n - 1 if self.n <= self.k else int(
            self.rng.integers(self.n))
        if slot < self.k:
            self.slots[slot] = (i, image)

    def kept(self) -> list:
        """[(i, image)] in the order of i."""
        return sorted(self.slots.values(), key=lambda r: r[0])


def pick_pixels(seed: int, medium: np.ndarray, k: int) -> np.ndarray:
    """Positions of k of the candidates (all where fewer): half drawn
    from the seed among the ``medium`` ones, the rest among all that are
    left."""
    rng = np.random.default_rng([seed % (1 << 64), 4])
    n = medium.shape[0]
    if k >= n:
        return np.arange(n)
    med = np.flatnonzero(medium)
    first = rng.choice(med, size=min(k // 2, med.shape[0]), replace=False)
    rest = np.setdiff1d(np.arange(n), first)
    second = rng.choice(rest, size=k - first.shape[0], replace=False)
    return np.sort(np.concatenate([first, second]))


def agreement(program: np.ndarray, ref: np.ndarray) -> dict:
    """off_frac, mean_diff and nonfinite of program pixels [..., 3]
    against the reference's."""
    program = np.asarray(program, np.float64).reshape(-1, 3)
    ref = np.asarray(ref, np.float64).reshape(-1, 3)
    if not program.size:
        return dict(off_frac=1.0, mean_diff=np.inf, nonfinite=0)
    finite = np.isfinite(program).all(-1)
    diff = np.where(finite[:, None], np.abs(program - ref), np.inf)
    off = (diff > OFF_ATOL + OFF_RTOL * np.abs(ref)).any(-1)
    return dict(off_frac=float(off.mean()),
                mean_diff=float(diff[finite].mean()) if finite.any()
                else np.inf,
                nonfinite=int((~finite).sum()))


def judge(numbers: dict, limits: dict) -> tuple:
    """(correct, checks): each number that ``limits`` names, and the
    EXACT ones (limit 0), beside its limit; correct where none exceeds
    it."""
    checks = {k: {"value": v, "limit": limits.get(k, 0)}
              for k, v in numbers.items() if k in limits or k in EXACT}
    return all(c["value"] <= c["limit"] for c in checks.values()), checks
