"""The work a render's paths need, and the least time the card could take
for it: copies of ``chip_smoke.py``'s constants and ``bound``.

The work follows the paths, not a kernel: for every bounce evaluation
(extension ray) and every shadow-ray segment, a box test of each 32-row
Morton group of the table, a division-free pre-test of each valid row of
the groups the ray meets, a pair test and a tau evaluation of each pair
it crosses, and the Newton steps and the albedo over the crossed pairs of
a ray that scatters (``reference.count_bounce`` counts them).  So it
reads the same whatever engine renders the cell.  The bytes are the
table read once and the image written once.
"""

from __future__ import annotations

# The card's peaks (NVIDIA H100 SXM data sheet): float32 outside the
# tensor cores, and HBM bandwidth.
PEAK_FLOPS, PEAK_BYTES = 67e12, 3.35e12
# Flops, an FMA as 2 and an erff/expf as 1, of: one (Gaussian, ray) pair
# test (csrc/bounce.cuh interval); one evaluation of a crossed pair at a
# point (tau_sig_at); one (box, ray) slab test (big.cuh box_admits); one
# division-free pre-test of a pair (may_cross).
PAIR_TEST_FLOPS = 94
CROSSED_EVAL_FLOPS = 13
BOX_TEST_FLOPS = 19
PRE_TEST_FLOPS = 56
SOLVER_ITERS = 12                 # RenderConfig.solver_iters
TABLE_ROW_BYTES = 16 * 4          # a Gaussian's row of the table
PIXEL_BYTES = 3 * 4               # a float32 RGB pixel


def flops(work: dict) -> float:
    """Operations of the counted work (``reference.count_bounce``)."""
    rays = work["evals"] + work["scattered"]
    return (BOX_TEST_FLOPS * rays * work["groups"]
            + PRE_TEST_FLOPS * (work["ext_rows"] + work["nee_rows"])
            + (PAIR_TEST_FLOPS + CROSSED_EVAL_FLOPS)
            * (work["ext_pairs"] + work["nee_pairs"])
            + CROSSED_EVAL_FLOPS * (SOLVER_ITERS + 1) * work["solve_pairs"])


def bound_s(work: dict, scale: float, gaussians: int, pixels: int,
            renders: int) -> dict:
    """The bound of ``renders`` renders of ``pixels`` pixels each, whose
    work ``work`` counts over 1 / ``scale`` of one render's pixels:
    {'flops', 'bytes', 'bound_s', 'bound_by'}."""
    ops = flops(work) * scale * renders
    nbytes = (gaussians * TABLE_ROW_BYTES + pixels * PIXEL_BYTES) * renders
    t_ops, t_bytes = ops / PEAK_FLOPS, nbytes / PEAK_BYTES
    return dict(flops=ops, bytes=nbytes, bound_s=max(t_ops, t_bytes),
                bound_by="operations" if t_ops >= t_bytes else "bytes")
