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
