"""Agreement measures for holding a kernel against its plain version (or
the JAX package), shared by the CPU tests, the card tests and
``scripts/ab_kernels.py``."""

from __future__ import annotations

import math

import numpy as np
import torch

from gvr_tpu_torch.cameras import PinholeCamera
from gvr_tpu_torch.integrators.multiscatter import tile_ids
from gvr_tpu_torch.kernels import pathtrace_big, wavefront

# Bars for two bounce results, from gvr_tpu's tests/test_pallas_kernels.py
# _check: scatter decisions agree on > 99.5 % of rays, tau to rtol 1e-3 /
# atol 1e-4, and, over rays both scatter, medians of |dt| and |dalbedo|
# below 1e-3 and of |dLi| below 2e-2 (medians, because a root near a support
# boundary may legitimately land on the other side on a few rays).
BOUNCE_BARS = dict(agree=0.995, tau_rtol=1e-3, tau_atol=1e-4, t=1e-3,
                   albedo=1e-3, li=2e-2)
# BOUNCE_BARS on the step wavefront's own rays:
# camera rays from 5-6 units away cross some Gaussians at the edge of the
# R_CUT clip, where the interval's width sqrt((R_CUT^2 - m2) / a) grows a
# relative rounding of m2 by m2 / (2 (R_CUT^2 - m2)), a thousandfold at
# R_CUT^2 - m2 = 4.5e-3, into the pair's tau.  Two float32 versions part
# there: the plain version in float32 against itself in float64 leaves
# rays with such a grazing pair beyond the tau bar
# (tests/test_torch_step.py).  So tau may miss its bar on at most
# tau_misses rays of a launch, and by no more than tau_cap in |dtau| on
# any ray; every other bar holds as it is.  On the headline's 65,536
# camera rays of chunk 9 on the H100, K2 against the plain version missed
# on 4 rays by |dtau| 5.25e-3 at most, and the plain version in float32
# against float64 on 6 by 9.28e-3 at most: the limits are 4x the first
# count and 2x the larger spread.
PATH_BOUNCE_BARS = dict(BOUNCE_BARS, tau_misses=16, tau_cap=2e-2)


def bounce_agreement(outs, refs, bars=BOUNCE_BARS) -> dict:
    """Measured agreement of two (t_sc, scattered, albedo, li, tau_tot)
    results (numpy arrays or tensors) and whether it meets ``bars``
    (BOUNCE_BARS, or PATH_BOUNCE_BARS)."""
    host = lambda x: (x.cpu().numpy() if isinstance(x, torch.Tensor)
                      else np.asarray(x))
    t_p, sc_p, alb_p, li_p, tau_p = (host(x) for x in outs[:5])
    t_x, sc_x, alb_x, li_x, tau_x = (host(x) for x in refs[:5])
    both = sc_p & sc_x
    excess = (np.abs(tau_p - tau_x) - bars["tau_atol"]
              - bars["tau_rtol"] * np.abs(tau_x))
    res = dict(
        agree=float((sc_p == sc_x).mean()),
        max_dtau=float(np.abs(tau_p - tau_x).max()),
        tau_excess=float(excess.max()),
        tau_beyond=int((excess > 0.0).sum()),
        n_both=int(both.sum()),
        t=float(np.median(np.abs(t_p - t_x)[both])) if both.any() else 0.0,
        albedo=float(np.median(np.abs(alb_p - alb_x)[both]))
        if both.any() else 0.0,
        li=float(np.median(np.abs(li_p - li_x)[both])) if both.any() else 0.0)
    tau_ok = (res["tau_beyond"] <= bars["tau_misses"]
              and res["max_dtau"] <= bars["tau_cap"]
              if "tau_misses" in bars else res["tau_excess"] <= 0.0)
    res["ok"] = bool(res["agree"] > bars["agree"] and tau_ok
                     and res["n_both"] > 10
                     and all(res[k] < bars[k] for k in ("t", "albedo", "li")))
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


# K1 at the main path's shape (the headline's 65,536-pixel chunks), two
# results per pixel (mean radiance; mega_agreement).  Rounding differences
# grow along a path, and a path whose scatter or RR test sits within them
# of its threshold takes the other branch and moves its pixel by its whole
# radiance / spp.  So the bars bound that radiance (max_path_diff), the
# share of pixels beyond OFF_ATOL/OFF_RTOL (off_frac), the mean |diff| over
# the chunk and the evaluation total.  On an NVIDIA H100 80GB HBM3 at
# 700.00 W the headline's chunk 9, kernel vs plain, measured max_path_diff
# 2.67 (spp 4) and 4.29 (spp 64), off_frac 1.2e-3 and 3.7e-3, mean_diff
# 2.3e-5 and 1.8e-5, evals_rel 8.7e-6 and 1.1e-6.
CHUNK_BARS = dict(max_path_diff=8.0, off_frac=1e-2, mean_diff=1e-4,
                  evals_rel=1e-4)


def chunk_agreement(outs, refs, spp: int) -> dict:
    """mega_agreement of two K1 results and 'ok', whether the radiance is
    finite and meets CHUNK_BARS."""
    res = mega_agreement(outs, refs, spp)
    res["ok"] = res["finite"] and all(res[k] <= CHUNK_BARS[k]
                                      for k in CHUNK_BARS)
    return res


def image_agreement(img, ref, spp: int) -> dict:
    """CHUNK_BARS' image terms of two mean-radiance images (numpy,
    [..., 3]) rendered with the same seed by two implementations: the
    max |diff| times spp, the share of pixels off, the mean |diff|, and
    'ok' when both are finite and within the bars."""
    img, ref = (torch.as_tensor(np.asarray(x, np.float32)).reshape(-1, 3)
                for x in (img, ref))
    res = mega_agreement((img * spp, torch.zeros(1)),
                         (ref * spp, torch.zeros(1)), spp)
    res["ok"] = bool(res["finite"] and torch.isfinite(ref).all()
                     and all(res[k] <= CHUNK_BARS[k]
                             for k in ("max_path_diff", "off_frac",
                                       "mean_diff")))
    return res


# An integrator's image on the card against the same render on the CPU
# (the same code, other rounding, and on the MC paths the paths that a
# threshold test within that rounding sends another way): the image means
# within 0.5 %, the per-pixel mean |diff| below 1e-3; the hit mask equal
# on 99.9 % of the pixels.
CARD_CPU_BARS = dict(mean_rel=5e-3, mean_abs_diff=1e-3, mask_equal=0.999)


def card_cpu_agreement(card, cpu, hitmask: bool = False) -> dict:
    """The CARD_CPU_BARS terms of two images (numpy [H, W, 3]) and 'ok'."""
    card, cpu = np.asarray(card, np.float64), np.asarray(cpu, np.float64)
    m_card, m_cpu = float(card.mean()), float(cpu.mean())
    res = dict(mean_card=m_card, mean_cpu=m_cpu,
               mean_rel=abs(m_card - m_cpu) / max(abs(m_cpu), 1e-12),
               mean_abs_diff=float(np.abs(card - cpu).mean()),
               finite=bool(np.isfinite(card).all()))
    if hitmask:
        res["mask_equal"] = float((card == cpu).all(-1).mean())
        res["ok"] = res["finite"] and \
            res["mask_equal"] >= CARD_CPU_BARS["mask_equal"]
    else:
        res["ok"] = (res["finite"]
                     and res["mean_rel"] <= CARD_CPU_BARS["mean_rel"]
                     and res["mean_abs_diff"] < CARD_CPU_BARS["mean_abs_diff"])
    return res


# A voxel bake (``VoxelGrid.from_gaussians``) on the card against the same
# bake on the CPU: each cell's sigma_t is a sum of N exp terms, rounded
# apart by the two exps and summation orders, so within rel of the cell's
# own value plus atol of the grid's largest; the albedo, a ratio of two such
# sums, within albedo_atol wherever sigma_t is above atol of the largest
# (in the near-empty cells both sums are rounding noise, and where the
# field crosses the 1e-25 threshold one side takes the mean-albedo filler).
BAKE_BARS = dict(rel=1e-5, atol=1e-6, albedo_atol=1e-4)


def bake_agreement(card, cpu) -> dict:
    """The BAKE_BARS terms of two VoxelGrids (the box equal, the largest
    excess of each field over its bar) and 'ok'."""
    st_card, st_cpu = card.sigma_t.cpu().double(), cpu.sigma_t.double()
    top = float(st_cpu.abs().max())
    dst = (st_card - st_cpu).abs()
    dense = st_cpu > BAKE_BARS["atol"] * top
    dal = (card.albedo.cpu().double() - cpu.albedo.double()).abs()[dense]
    res = dict(box_equal=bool(torch.equal(card.lo.cpu(), cpu.lo)
                              and torch.equal(card.hi.cpu(), cpu.hi)),
               max_dsigma_t=float(dst.max()), sigma_t_max=top,
               sigma_t_excess=float((dst - BAKE_BARS["rel"] * st_cpu.abs()
                                     - BAKE_BARS["atol"] * top).max()),
               max_dalbedo_dense=float(dal.max()) if dense.any() else 0.0,
               dense_share=float(dense.double().mean()))
    res["ok"] = (res["box_equal"] and res["sigma_t_excess"] <= 0.0
                 and res["max_dalbedo_dense"] <= BAKE_BARS["albedo_atol"])
    return res


def gif_structure(raw: bytes) -> dict:
    """Walk a GIF89a's blocks: the signature, the logical screen's width
    and height, the image descriptors (frames) and whether the trailer 0x3b
    ends the file right after the last block."""
    out = dict(signature=raw[:6] == b"GIF89a",
               width=int.from_bytes(raw[6:8], "little"),
               height=int.from_bytes(raw[8:10], "little"), frames=0,
               trailer=False)
    pos = 13 + (3 << ((raw[10] & 7) + 1) if raw[10] & 0x80 else 0)

    def skip_sub_blocks(p):
        while raw[p]:
            p += raw[p] + 1
        return p + 1

    while pos < len(raw):
        tag = raw[pos]
        if tag == 0x3B:
            out["trailer"] = pos == len(raw) - 1
            break
        if tag == 0x21:                        # extension: label, blocks
            pos = skip_sub_blocks(pos + 2)
        elif tag == 0x2C:                      # image: descriptor, table,
            flags = raw[pos + 9]               # LZW code size, blocks
            pos += 10 + (3 << ((flags & 7) + 1) if flags & 0x80 else 0)
            pos = skip_sub_blocks(pos + 1)
            out["frames"] += 1
        else:
            break
    return out


# The inverse renderer's loss and gradient (``inverse/fit.fit_loss``) from
# two implementations on the same parameter vector, rays and streams: the
# port against the JAX package on the CPU, or the card against the CPU.
# The loss within loss_rel of the other's, the gradient within grad_rel
# in relative L2 and its cosine above cos.  On the CPU the port measured
# 2.4e-6 to 2.7e-6 relative L2 against jax.grad on the two-Gaussian scene
# of tests/test_inverse.py (all three losses); a lane whose p_scat or RR
# test sits within rounding of its threshold may take the other branch in
# one implementation, which the relative L2 absorbs.
FIT_BARS = dict(loss_rel=1e-4, grad_rel=1e-3, cos=0.9999)


def fit_agreement(loss, grad, loss_ref, grad_ref) -> dict:
    """The FIT_BARS terms of two (loss, gradient) results (numbers and
    numpy arrays or tensors) and 'ok'."""
    host = lambda x: np.asarray(x.detach().cpu().numpy()
                                if isinstance(x, torch.Tensor) else x,
                                np.float64)
    g, g_ref = host(grad), host(grad_ref)
    loss, loss_ref = float(host(loss)), float(host(loss_ref))
    norm = max(float(np.linalg.norm(g_ref)), 1e-30)
    res = dict(loss=loss, loss_ref=loss_ref,
               loss_rel=abs(loss - loss_ref) / max(abs(loss_ref), 1e-30),
               grad_rel=float(np.linalg.norm(g - g_ref)) / norm,
               cos=float(g @ g_ref) / max(float(np.linalg.norm(g)) * norm,
                                          1e-30),
               finite=bool(np.isfinite(g).all() and np.isfinite(loss)))
    res["ok"] = bool(res["finite"] and res["loss_rel"] <= FIT_BARS["loss_rel"]
                     and res["grad_rel"] <= FIT_BARS["grad_rel"]
                     and res["cos"] >= FIT_BARS["cos"])
    return res


# A tensor-parallel render (the mixture sharded over a gauss group, every
# Gaussian-axis sum completed by an all-reduce) against the one-device
# estimator: tests/test_gauss_sharded.py's _assert_radiance_close.  The
# shard-split float32 sums move tau by ~1e-7 relative, which the Newton
# root amplifies where sigma_t is small: every element within rtol /
# atol 2e-3, the means within 1e-5 and the 99th percentile of |diff|
# below 1e-4.
TP_BARS = dict(rtol=2e-3, atol=2e-3, mean_diff=1e-5, p99=1e-4)


def tp_agreement(got, want) -> dict:
    """The TP_BARS terms of two radiance arrays (numpy) and 'ok'."""
    got, want = (np.asarray(x, np.float64) for x in (got, want))
    diff = np.abs(got - want)
    res = dict(max_excess=float((diff - TP_BARS["atol"]
                                 - TP_BARS["rtol"] * np.abs(want)).max()),
               max_diff=float(diff.max()),
               mean_diff=float(abs(got.mean() - want.mean())),
               p99=float(np.percentile(diff, 99)),
               finite=bool(np.isfinite(got).all()))
    res["ok"] = bool(res["finite"] and res["max_excess"] <= 0
                     and res["mean_diff"] < TP_BARS["mean_diff"]
                     and res["p99"] < TP_BARS["p99"])
    return res


# The implicit-function VJP of solve_conditional_free_flight against
# central differences of the solve itself: f(p) = sum_r w_r t_r(p), the
# roots of the rays' conditioned targets in the mixture decoded from p,
# along random unit directions v at step eps.  A directional derivative
# is off when |fd - ad| exceeds rel times the larger of the two or of
# floor (the float32 noise of the difference quotient, ~0.01 over 256
# rays); at most ``misses`` may be off (a root that crosses a Gaussian's
# interval end inside the step has a kink there), as in the JAX
# package's tests/test_inverse.py finite-difference test.  On the CPU,
# the 10-Gaussian scene's 16^2 camera rays measured at most 0.15 over
# 18 directions, and a VJP of the wrong sign 0.6-1.2 on every one.
SOLVE_FD_BARS = dict(eps=1e-3, rel=0.2, floor=0.1, dirs=6, misses=1)


def solve_fd_agreement(scene, origin, direction, u, seed: int = 0) -> dict:
    """SOLVE_FD_BARS for rays origin/direction [B,3] and uniforms u [B] on
    the device of ``scene``: the targets are the estimator's,
    -log1p(-u p_scat 0.999999), p_scat = 1 - exp(-tau_total), so the
    gradient takes both the parameters' and the target's cotangents.
    Returns the autograd and finite-difference derivatives, the relative
    errors, and 'ok'."""
    from gvr_tpu_torch.ops.solvers import solve_conditional_free_flight
    from gvr_tpu_torch.ops.transmittance import tau_coeffs, tau_total
    from gvr_tpu_torch.scene.gaussians import GaussianMixture
    r = np.random.default_rng(seed)
    dev = scene.medium.mean.device
    p0 = scene.medium.pack_parameters().detach()
    w = torch.tensor(r.normal(size=origin.shape[0]), dtype=torch.float32,
                     device=dev)

    def f(p):
        rg = tau_coeffs(GaussianMixture.from_parameters(p), origin,
                        direction)
        p_scat = 1.0 - torch.exp(-tau_total(rg))
        target = -torch.log1p(-u * p_scat * 0.999999)
        return torch.sum(w * solve_conditional_free_flight(rg, target))

    p = p0.clone().requires_grad_(True)
    f(p).backward()
    eps = SOLVE_FD_BARS["eps"]
    ad, fd = [], []
    with torch.no_grad():
        for _ in range(SOLVE_FD_BARS["dirs"]):
            v = r.normal(size=p0.shape[0])
            v = torch.tensor(v / np.linalg.norm(v), dtype=torch.float32,
                             device=dev)
            ad.append(float(p.grad @ v))
            fd.append((float(f(p0 + eps * v)) - float(f(p0 - eps * v)))
                      / (2.0 * eps))
    rel = [abs(a - b) / max(abs(a), abs(b), SOLVE_FD_BARS["floor"])
           for a, b in zip(ad, fd)]
    res = dict(autograd=ad, central=fd, rel=rel,
               finite=bool(torch.isfinite(p.grad).all()))
    res["ok"] = bool(res["finite"] and sum(
        x > SOLVE_FD_BARS["rel"] for x in rel) <= SOLVE_FD_BARS["misses"])
    return res


def scene_text(scene) -> str:
    """GMM text (scene.h:38-120) of a port Scene: its lights, then each
    Gaussian's mean, covariance (xx xy xz yy yz zz), density and albedo,
    every number as %.9g, so the text parses back to the same float32
    values."""
    f = lambda row: " ".join(f"{float(v):.9g}" for v in row)
    lights = torch.cat([scene.lights_p, scene.lights_i], 1).cpu().numpy()
    m = scene.medium
    cov = m.cov.detach().cpu().numpy()
    rows = np.concatenate([
        m.mean.detach().cpu().numpy(),
        cov[:, [0, 0, 0, 1, 1, 2], [0, 1, 2, 1, 2, 2]],
        m.density.detach().cpu().numpy()[:, None],
        m.albedo.detach().cpu().numpy()[:, None]], 1)
    return "".join([f"l {f(r)}\n" for r in lights]
                   + [f"g {f(r)}\n" for r in rows])


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
# On an NVIDIA H100 80GB HBM3 at 700.00 W the kernel measured at most 43 %
# of this bound and 1.4e-4 of the slots beyond the base (at one grid
# iteration's shapes of the 10k scene's 512^2 render); float32 vs float64
# of the plain version 3.8 % and none.
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
# support end may count that Gaussian in one version only).  On an NVIDIA
# H100 80GB HBM3 at 700.00 W the kernel left 1 of 16,395 and 1 of 28,776
# rays outside the t bar and 0 and 2 outside the albedo bar (random rays,
# and one grid iteration's shapes of the 10k scene's 512^2 render).
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


# K4 + K5 (the big-N bounce), per ray.  Derived from the plain version in
# float32 against itself in float64 on random_gaussian_scene(10_000, 0)
# (CPU; 2,048 camera rays of the 512^2 image through the medium, 2,048
# random rays from inside it, and 4,096 camera rays after one bounce):
# scatter decisions agree on every ray; tau_tot is within 1e-4 + 1e-3 |tau|
# on all but 1 ray in 2,048 (5.8x over: the erf difference of a thin
# Gaussian cancels, as for K6), so a share must meet the tau bar.  K4's
# inset Illinois step does not converge on a few rays, whose root after
# solver_iters steps then moves with rounding: of the rays that scatter in
# both, t is within 1e-5 + 1e-4 |t| on 99.94 % of the first rays but only
# 98.64 % after a bounce, and within 1e-3 + 1e-2 |t| on 100 % and 99.969 %
# (max |dt| 3.3e-3).  The albedo is within 1e-3 on all of them (a root
# 1 % away may see another mix of Gaussians, so a share must meet it), and
# K5 on the same NEE rays within 1e-4 + 1e-3 |Li| on every ray (at most
# 0.14 of the bound).  Li is held on the rays whose t agrees, so a kernel and its
# plain version compare Li on the same shadow rays.  Plain mutants miss
# the t bar: Illinois clipped to [lo, hi] instead of the 5 % inset leaves
# 99.63 % (first rays) and 97.47 % (after a bounce) within, skipping the
# pairs of each 64-ray block's last crossed chunk 78.5 %.
BIG_BARS = dict(agree=0.999, tau_atol=1e-4, tau_rtol=1e-3, tau_share=0.998,
                t_atol=1e-3, t_rtol=1e-2, share=0.999, albedo=1e-3,
                albedo_share=0.998, li_atol=1e-4, li_rtol=1e-3)
# BIG_BARS where every ray crosses thousands of overlapping Gaussians (the
# S_CAP_MAX fallback scene, random_gaussian_scene(8000, 0, diameter 2-4):
# tau_tot from 29, median 121, on big_rays): there K4's inset Illinois
# step leaves 1-2 % of the roots short of convergence after solver_iters
# steps, where they move with the order of the sums.  The plain version in
# float32 against itself with the rows permuted kept t within the t bar on
# 98.8 % of 1,024 rays (max |dt| 0.042), in float64 on 97.9 % (0.060;
# CPU), so 95 % of the rays must be within; every other bar held there as
# it is.
BIG_DENSE_BARS = dict(BIG_BARS, share=0.95)


def big_agreement(outs, refs, bars=BIG_BARS) -> dict:
    """Measured agreement of two (t_sc, scattered, albedo, li [B,3],
    tau_tot) bounce results (numpy arrays or tensors) and whether it meets
    ``bars`` (BIG_BARS, or BIG_DENSE_BARS)."""
    host = lambda x: (x.cpu().numpy() if isinstance(x, torch.Tensor)
                      else np.asarray(x))
    t_p, sc_p, alb_p, li_p, tau_p = (host(x) for x in outs[:5])
    t_x, sc_x, alb_x, li_x, tau_x = (host(x) for x in refs[:5])
    dtau = np.abs(tau_p - tau_x)
    t_ok = np.abs(t_p - t_x) <= bars["t_atol"] + bars["t_rtol"] * np.abs(t_x)
    both = sc_p & sc_x
    alb_ok = np.abs(alb_p - alb_x) <= bars["albedo"]
    dli = np.abs(li_p - li_x)[t_ok]
    li_bound = bars["li_atol"] + bars["li_rtol"] * np.abs(li_x[t_ok])
    share = lambda m: float(m.mean()) if m.size else 1.0
    res = dict(
        n=int(t_p.shape[0]), agree=float((sc_p == sc_x).mean()),
        tau_within=share(dtau <= bars["tau_atol"]
                         + bars["tau_rtol"] * np.abs(tau_x)),
        max_dtau=float(dtau.max()), n_both=int(both.sum()),
        t_within=share(t_ok[both]),
        max_dt=float(np.abs(t_p - t_x)[both].max()) if both.any() else 0.0,
        albedo_within=share(alb_ok[both & t_ok]),
        li_rays=int(t_ok.sum()),
        li_worst_ratio=float((dli / li_bound).max()) if dli.size else 0.0,
        max_dli=float(dli.max()) if dli.size else 0.0)
    res["ok"] = bool(res["agree"] >= bars["agree"]
                     and res["tau_within"] >= bars["tau_share"]
                     and res["n_both"] > 10
                     and res["t_within"] >= bars["share"]
                     and res["albedo_within"] >= bars["albedo_share"]
                     and res["li_worst_ratio"] <= 1.0)
    return res


def big_rays(medium, n: int, seed: int, device):
    """(o, d, xi) of the big-N kernel checks: n tile-order camera rays
    through pixel centres of the 512^2 image (pinhole at (0,1,6) looking at
    (0,1,0), FOV 45 degrees), from the band of tile rows 31-32 across the
    medium, then n rays from uniform points inside the box of the Gaussian
    means in uniform directions; xi [2n, 5] uniforms.  All from numpy seed
    ``seed``, float32 on ``device``."""
    ids = tile_ids(512, 512, "cpu")[31 * 4096:31 * 4096 + n].long().numpy()
    uv = np.stack([(ids % 512 + 0.5) / 512, (ids // 512 + 0.5) / 512], -1)
    cam = PinholeCamera.create([0, 1, 6], [0, 1, 0], math.radians(45.0),
                               device=device)
    o1, d1 = cam.sample_ray(torch.tensor(uv, dtype=torch.float32,
                                         device=device))
    r = np.random.default_rng(seed)
    mean = medium.mean.cpu().numpy()
    o2 = r.uniform(mean.min(0), mean.max(0), (n, 3))
    d2 = r.normal(size=(n, 3))
    d2 /= np.linalg.norm(d2, axis=1, keepdims=True)
    f32 = lambda a: torch.tensor(a, dtype=torch.float32, device=device)
    return (torch.cat([o1, f32(o2)]), torch.cat([d1, f32(d2)]).contiguous(),
            f32(r.uniform(size=(2 * n, 5))))


def big_kernel_vs_plain(table, boxes, o, d, xi, lights, env,
                        solver_iters: int = 12, bars=BIG_BARS) -> dict:
    """K4 and K5 against their plain versions on one batch (CUDA tensors):
    big_agreement of the two bounces at ``bars``, with K5 and its plain
    version both given K4's NEE rays, so Li is compared on the same shadow
    rays; and the chunks and groups each kernel's box tests admitted
    against ``admitted_counts_reference`` on the same rays, which must be
    equal ray for ray (the same float32 operations): 'k4_admitted' and
    'k5_admitted' are the means per ray (chunks, groups); and K4's
    overflow count against the rays that cross more than MAX_HITS pairs
    (``culling_stats``), 'overflow' the two.  'ok' also needs both
    equalities."""
    pb = pathtrace_big
    b = o.shape[0]
    adm4, adm5 = (torch.empty((2, b), dtype=torch.int32, device=o.device)
                  for _ in range(2))
    over = torch.zeros(1, dtype=torch.int32, device=o.device)
    s1 = pb.big_stage1(table, o, d, xi, lights, solver_iters, boxes, adm4,
                       over)
    s1_plain = pb.big_stage1_reference(table, o, d, xi, lights, solver_iters)
    li, li_plain = (pb.big_nee(table, s1, env, boxes, adm5),
                    pb.big_nee_reference(table, s1, env))
    torch.cuda.synchronize()
    bounce = lambda s, l: (s[0], s[1] > 0.5, s[2], l, s[3])
    res = big_agreement(bounce(s1, li), bounce(s1_plain, li_plain), bars)
    want4 = pb.admitted_counts_reference(boxes, o, d)
    want5 = pb.admitted_counts_reference(boxes, s1[4:7].T, s1[7:10].T,
                                         s1[10])
    means = lambda a: [float(x) for x in a.float().mean(1)]
    crossed = pb.culling_stats(table, boxes, o, d)["crossed"]
    res.update(k4_admitted=means(adm4), k5_admitted=means(adm5),
               admitted_equal=bool(torch.equal(adm4, want4)
                                   and torch.equal(adm5, want5)),
               overflow=[int(over), int((crossed > pb.MAX_HITS).sum())])
    res["ok"] = (res["ok"] and res["admitted_equal"]
                 and res["overflow"][0] == res["overflow"][1])
    return res


def big_loops(scene, camera, cfg, ids) -> list:
    """The big-N loop (``wavefront_pixels_big``: the live lanes kept on the
    device) and the loop with a host read an iteration
    (``multiscatter._table_wavefront``) with K4 and K5
    (``bounce_step_big``) over the pixel ids [B] of one chunk, each under
    a RenderStats: [(radiance [B, 3], the stats dict, the counters)] of
    the two."""
    from gvr_tpu_torch.integrators import multiscatter
    from gvr_tpu_torch.utils import profiling

    pb = pathtrace_big
    table, boxes = pb.pack_rows(scene.medium), pb.chunk_boxes(scene.medium)
    bounce = lambda o, d, xi, lights, env: pb.bounce_step_big(
        table, o, d, xi, lights, env, cfg.solver_iters, boxes)
    runs = (lambda st: multiscatter.wavefront_pixels_big(
                scene, camera, cfg, ids, st, (table, boxes)),
            lambda st: multiscatter._table_wavefront(
                scene, camera, cfg, ids, st, bounce))
    out = []
    for run in runs:
        rec, st = profiling.RenderStats(), {}
        with rec.span("chunk"):
            img = run(st)
        out.append((img, st, rec.counters))
    return out


def roulette_edges(cfg, thr, albedo, bounce, u) -> torch.Tensor:
    """Russian roulette's draws u [n] of lanes with throughput thr [n, 3],
    the bounce's albedo [n] and bounce [n], with every third lane's draw
    set to its survival probability (it survives) and the next lane's one
    ulp above it (it is killed), where roulette applies: the edges of
    ``kernels/wavefront.roulette``'s test."""
    b = bounce.to(torch.int64)
    cap = torch.where(b >= cfg.rr_tail_after, cfg.rr_cap_tail,
                      cfg.rr_cap).to(torch.float32)
    rr = torch.minimum((thr * albedo[:, None]).amax(dim=-1), cap)
    k = torch.arange(u.shape[0], device=u.device) % 3
    u = torch.where(k == 0, rr, u)
    u = torch.where(k == 1, torch.nextafter(rr, torch.full_like(rr, 2.0)), u)
    # the edges decide as the plain roulette does
    killed = wavefront.roulette(cfg, thr, albedo, bounce, u)[1]
    do_rr = b >= cfg.min_scatter
    assert not killed[(k == 0) & do_rr].any()
    assert killed[(k == 1) & do_rr].all()
    return u


def random_lanes(cfg, camera, b: int, device, seed: int):
    """Random wavefront lanes for holding the glue of
    ``kernels/wavefront`` (K8 or its plain version) against another
    version: (lanes, live, res, edges).  The b lanes hold distinct pixel
    ids; a third are alive, the rest dead: with samples left (a fifth of
    them at the last sample) or finished; bounces in [0, max_bounces),
    a tenth at max_bounces - 1.  ``live`` is the loop's live read of them,
    ``res`` random bounce results (t_sc, scattered, albedo, li [n, 3]) of
    the live lanes, ``edges(lanes, u)`` ``roulette_edges`` on the live
    lanes of ``lanes`` after the pre-bounce step."""
    g = torch.Generator().manual_seed(seed)
    rnd = lambda *shape: torch.rand(shape, generator=g)
    ri = lambda lo, hi, n: torch.randint(lo, hi, (n,), generator=g)
    spp, mb = cfg.spp, cfg.max_bounces
    assert b <= cfg.width * cfg.height
    ids = torch.randperm(cfg.width * cfg.height, generator=g)[:b]
    L = wavefront.lanes(ids.to(torch.int32).to(device), camera)
    alive = rnd(b) < 1 / 3
    sample = torch.where(alive, ri(1, spp + 1, b), ri(0, spp + 1, b))
    sample = torch.where(~alive & (rnd(b) < 0.2), spp - 1, sample)
    bounce = torch.where(rnd(b) < 0.1, mb - 1, ri(0, mb, b))
    d = torch.randn((b, 3), generator=g)
    f32 = lambda t: t.to(torch.float32).to(device)
    L.o = f32(torch.randn((b, 3), generator=g))
    L.d = f32(d / torch.linalg.vector_norm(d, dim=-1, keepdim=True))
    L.thr = f32(rnd(b, 3))
    L.acc = f32(rnd(b, 3) * 2.0)
    L.alive = alive.to(device)
    L.sample = sample.to(torch.int32).to(device)
    L.bounce = bounce.to(torch.int32).to(device)
    live = torch.nonzero(L.alive | (L.sample < spp)).squeeze(1)
    n = live.shape[0]
    res = (f32(rnd(n) * 3.0), (rnd(n) < 0.7).to(device), f32(rnd(n)),
           f32(rnd(n, 3) * 5.0))

    def edges(lanes, u):
        return roulette_edges(cfg, lanes.thr[live], res[2],
                              lanes.bounce[live], u)

    return L, live, res, edges
