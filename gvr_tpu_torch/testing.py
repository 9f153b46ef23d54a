"""Agreement measures for holding a kernel against its plain version (or
the JAX package), shared by the tests and ``chip_smoke.py``."""

from __future__ import annotations

import numpy as np
import torch

# Bars for two bounce results, from gvr_tpu's tests/test_pallas_kernels.py
# _check: scatter decisions agree on > 99.5 % of rays, tau to rtol 1e-3 /
# atol 1e-4, and, over rays both scatter, medians of |dt| and |dalbedo|
# below 1e-3 and of |dLi| below 2e-2 (medians, because a root near a support
# boundary may legitimately land on the other side on a few rays).
BOUNCE_BARS = dict(agree=0.995, tau_rtol=1e-3, tau_atol=1e-4, t=1e-3,
                   albedo=1e-3, li=2e-2)


def bounce_agreement(outs, refs) -> dict:
    """Measured agreement of two (t_sc, scattered, albedo, li, tau_tot)
    results (numpy arrays or tensors) and whether it meets BOUNCE_BARS."""
    host = lambda x: (x.cpu().numpy() if isinstance(x, torch.Tensor)
                      else np.asarray(x))
    t_p, sc_p, alb_p, li_p, tau_p = (host(x) for x in outs[:5])
    t_x, sc_x, alb_x, li_x, tau_x = (host(x) for x in refs[:5])
    both = sc_p & sc_x
    dtau = np.abs(tau_p - tau_x)
    res = dict(
        agree=float((sc_p == sc_x).mean()),
        max_dtau=float(dtau.max()),
        tau_excess=float((dtau - BOUNCE_BARS["tau_atol"]
                          - BOUNCE_BARS["tau_rtol"] * np.abs(tau_x)).max()),
        n_both=int(both.sum()),
        t=float(np.median(np.abs(t_p - t_x)[both])) if both.any() else 0.0,
        albedo=float(np.median(np.abs(alb_p - alb_x)[both]))
        if both.any() else 0.0,
        li=float(np.median(np.abs(li_p - li_x)[both])) if both.any() else 0.0)
    res["ok"] = bool(res["agree"] > BOUNCE_BARS["agree"]
                     and res["tau_excess"] <= 0.0 and res["n_both"] > 10
                     and all(res[k] < BOUNCE_BARS[k]
                             for k in ("t", "albedo", "li")))
    return res


# A pixel is "off" when its mean radiance differs by more than the bounce
# bars' tau tolerance carried over: OFF_ATOL + OFF_RTOL * |reference|.
OFF_ATOL, OFF_RTOL = 1e-4, 1e-3


def mega_agreement(outs, refs, spp: int) -> dict:
    """Measured agreement of two megakernel results (radiance sums [B,3],
    bounce evaluations [B]): per-pixel max and mean |difference| of the
    mean radiance; the max times spp (the radiance one path would have to
    change by to explain it); the share of pixels off (see OFF_ATOL); and
    the relative difference of the evaluation totals."""
    diff = ((outs[0] - refs[0]) / spp).abs()
    ref = (refs[0] / spp).abs()
    off = (diff > OFF_ATOL + OFF_RTOL * ref).any(-1)
    n_out, n_ref = int(outs[1].sum()), int(refs[1].sum())
    max_diff = float(diff.max())
    return dict(max_diff=max_diff, max_path_diff=max_diff * spp,
                mean_diff=float(diff.mean()), off_frac=float(off.float().mean()),
                evals=n_out, evals_rel=abs(n_out - n_ref) / max(n_ref, 1),
                finite=bool(torch.isfinite(outs[0]).all()))


# K6, kernel vs plain, per (ray, crossing) slot: the bounce bars' tau
# tolerance, plus the float32 resolution of the form both versions share
# with the TPU kernel, tau_i = pref * (erf(z1) - erf(z0)) with z = sa * t +
# zoff.  sa * t and zoff nearly cancel, so each z carries an error up to
# ~2^-23 sa t, and the pair's tau one up to ~2 * 2^-23 * peak * t over both
# ends (pref * erf' <= peak / sa).  Two versions rounding apart, with FMA
# contraction in the kernel only, may differ by twice that:
#   |dtau| <= atol + rtol |tau| + resolution * peak * t_out,
# peak the densest entry of the slot's cell, t_out the crossing's far end.
# The resolution term only admits the few slots of the thinnest Gaussians,
# so at most beyond_share of the live slots may exceed atol + rtol |tau|.
# On the H100 the kernel measured at most 43 % of this bound and 1.4e-4 of
# the slots beyond the base (chip_smoke phase 10); float32 vs float64 of
# the plain version 3.8 % and none.
K6_BARS = dict(atol=1e-4, rtol=1e-3, resolution=4 * 2.0 ** -23,
               beyond_share=1e-3)


def span_tau_agreement(got, want, grid, cells, t_out) -> dict:
    """Measured agreement of two [R, C] K6 results on the crossings
    (cells, t_out) of ``dda_crossings`` and whether it meets K6_BARS."""
    n = grid.n_entries
    cell_of = grid.table[:n, 9].long()
    peak = torch.zeros(grid.n_cells, dtype=torch.float32,
                       device=want.device).scatter_reduce(
        0, cell_of, grid.table[:n, 10], "amax")
    slot_peak = torch.where(cells >= 0, peak[cells.clamp(min=0).long()], 0.0)
    err = (got - want).abs()
    base = K6_BARS["atol"] + K6_BARS["rtol"] * want.abs()
    bound = base + K6_BARS["resolution"] * slot_peak * t_out.abs()
    res = dict(slots=int((cells >= 0).sum()), max_err=float(err.max()),
               max_tau=float(want.max()),
               beyond_base=int((err > base).sum()),
               worst_excess=float((err - bound).max()),
               worst_ratio=float((err / bound).max()))
    res["ok"] = bool(res["worst_excess"] <= 0.0 and res["beyond_base"]
                     <= K6_BARS["beyond_share"] * max(res["slots"], 1))
    return res


# K7, kernel vs plain, per ray with a live critical cell.  With the erfinv
# finisher both versions land on the root to float32 rounding: float32 vs
# float64 of the plain version keeps every t within t_atol + t_rtol |t| on
# the 10k grid, while without the finisher 2.2 % of the roots fall outside.
# A root next to a threshold (a support end, the finisher's active test) may
# take the other branch in one version, so a share of the rays must meet
# the t bar, and of those the same share the albedo bar (a root at a
# support end may count that Gaussian in one version only).  On the H100
# the kernel left 1 of 16,395 and 1 of 28,776 rays outside the t bar and 0
# and 2 outside the albedo bar (chip_smoke phases 8 and 10).
K7_BARS = dict(t_atol=1e-5, t_rtol=1e-4, albedo=1e-3, share=0.999)


def solve_agreement(got, want, cells) -> dict:
    """Measured agreement of two K7 results (t_sc, albedo) [B] over the
    rays whose critical cell ``cells`` is live, and whether it meets
    K7_BARS."""
    live = cells >= 0
    t_w = want[0][live]
    dt = (got[0][live] - t_w).abs()
    da = (got[1][live] - want[1][live]).abs()
    t_ok = dt <= K7_BARS["t_atol"] + K7_BARS["t_rtol"] * t_w.abs()
    n = int(live.sum())
    res = dict(n=n, t_median=float(dt.median()) if n else 0.0,
               t_max=float(dt.max()) if n else 0.0,
               t_within=float(t_ok.float().mean()) if n else 1.0,
               albedo_max=float(da[t_ok].max()) if t_ok.any() else 0.0,
               albedo_within=float((da[t_ok] <= K7_BARS["albedo"])
                                   .float().mean()) if t_ok.any() else 1.0)
    res["ok"] = bool(n > 0 and res["t_within"] >= K7_BARS["share"]
                     and res["albedo_within"] >= K7_BARS["share"])
    return res
