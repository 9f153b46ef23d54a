"""Faults planted under the timed path, to show that the check catches
them: in the program's entry that a cell's ``cells/<cell>.json`` names
(``entry``, a dotted path: the function ``render_multiscatter`` calls
for each chunk of pixels, the megakernel's launcher or a wavefront), as
a faulty change of the program would break it.  The entry takes its
``RenderConfig`` as ``cfg`` and returns the chunk's radiance, or a tuple
whose first item is the radiance summed over the samples.

* ``unchanged``: the chunk's result left as it was made, all zero;
* ``half_samples``: each pixel's mean taken over half of its samples;
* ``altered``: every sixteenth answer of a chunk altered where it is
  produced: doubled, as a pixel whose samples were added twice would be.

A cell runs on one card, so no exchange between cards can be left out.
"""

from __future__ import annotations

import contextlib
import importlib
import inspect

FAULTS = ("unchanged", "half_samples", "altered")


@contextlib.contextmanager
def planted(entry: str, fault: str):
    """Within the block, ``fault`` breaks the program's ``entry``."""
    import torch

    where, name = entry.rsplit(".", 1)
    mod = importlib.import_module(where)
    orig = getattr(mod, name)
    at = list(inspect.signature(orig).parameters).index("cfg")

    def broken(*args, **kw):
        cfg = args[at]
        if fault == "half_samples":
            half = cfg.replace(spp=max(cfg.spp // 2, 1))
            out = orig(*args[:at], half, *args[at + 1:], **kw)
            if isinstance(out, tuple):
                return (out[0] * (cfg.spp / half.spp),) + tuple(out[1:])
            return out
        out = orig(*args, **kw)
        val = out[0] if isinstance(out, tuple) else out
        if fault == "unchanged":
            val = torch.zeros_like(val)
        elif fault == "altered":
            val = val.clone()
            val[::16] *= 2.0
        else:
            raise ValueError(f"unknown fault {fault!r}")
        return (val,) + tuple(out[1:]) if isinstance(out, tuple) else val

    setattr(mod, name, broken)
    try:
        yield
    finally:
        setattr(mod, name, orig)
