"""The general generator of a traffic mix: what each render of a run is.

Every mix is a closed loop with one client: renders back to back, the
next sent when the last image is on the host, like a user accumulating
passes of one view.  A traffic file (``traffic/<name>.json``) states:

* ``kind``: the kind of cell, ``kinds/<kind>.py``, which makes the
  program's scene and entry and the reference's check;
* ``render``: the fields of each render's ``RenderConfig`` (size, spp,
  engine, ...), passed as they are;
* ``trace_renders``: renders profiled in a ``--trace 1`` run;
* ``check_renders`` and ``check_pixels``: renders of the window, drawn
  from the seed, and pixels of each, compared with the reference;
* ``count_pixels``: pixels of a profiled render whose paths the work
  count traces.

Render i of a run renders with ``RenderConfig.seed = render_seed(seed,
i)``, so no render repeats another's samples; render 0 is the warm-up.
"""

from __future__ import annotations

import numpy as np

COUNTS = ("trace_renders", "check_renders", "check_pixels", "count_pixels")


def check_traffic(traffic: dict) -> None:
    """Raise on a traffic file the generator cannot run."""
    name = traffic.get("name")
    if not isinstance(traffic.get("kind"), str) or not isinstance(
            traffic.get("render"), dict):
        raise ValueError(f"traffic {name}: needs a kind and a render dict")
    for key in COUNTS:
        if not (isinstance(traffic.get(key), int) and traffic[key] > 0):
            raise ValueError(f"traffic {name}: {key} must be a positive "
                             f"integer")


def render_seed(seed: int, i: int) -> int:
    """The 32-bit RNG seed of render i of a run at ``seed``."""
    return int(np.random.SeedSequence([seed % (1 << 64), i])
               .generate_state(1)[0])


def render_kwargs(traffic: dict, seed: int, i: int) -> dict:
    """The RenderConfig fields of render i."""
    return dict(traffic["render"], seed=render_seed(seed, i))


def pixels(traffic: dict) -> int:
    """Pixels of a render."""
    return traffic["render"]["width"] * traffic["render"]["height"]


def paths(traffic: dict) -> int:
    """Paths of a render: pixels x samples per pixel."""
    return pixels(traffic) * traffic["render"]["spp"]


def draw(seed: int, stream: int, n: int, k: int) -> np.ndarray:
    """k distinct sorted indices of range(n) (all of them where k >= n),
    drawn from ``seed`` on its stream ``stream``."""
    rng = np.random.default_rng([seed % (1 << 64), stream])
    if k >= n:
        return np.arange(n)
    return np.sort(rng.choice(n, size=k, replace=False))


# the streams of ``draw`` and of the reservoir
PIXELS, RENDERS, COUNT = 1, 2, 3
