"""Uniform-grid acceleration index and its 3D-DDA: the grid engine's
structure.

Counterpart of ``gvr_tpu/accel/grid.py`` (the reference accelerates the
same per-ray work with a BVH, ``gmm.h:231-578``).  Every Gaussian is
inserted into each cell of a uniform grid that its R_CUT support actually
touches; the entries are sorted by cell into one feature table, and a
ray's t-ordered cell crossings are the segments of regular tracking.  Per
ray, the work is proportional to the Gaussians along it.

The host build (``choose_side``, ``build_grid``) is numpy in float64, as
in the JAX package, so the same mixture gives the same side, ``s_cap``,
counts and entry order in both.  What is not carried over:

- the span view ``table2`` (every cell's run aligned to a 128-entry slice,
  plus ``SPAN_PAD`` over-read slices): it exists for the TPU kernel's
  manual DMA.  K6 and K7 read a cell's entries straight from ``table`` by
  ``cell_first`` / ``cell_count``;
- the sort-only work lists (``sort_items``, ``pad_sort_items``): they
  avoid per-item gathers, which cost ~10 ns an element on the TPU and are
  cheap on the GPU.

``s_cap`` is still counted on 32-entry slices and held to ``S_CAP_MAX``,
so a scene takes the same engine in both packages.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from gvr_tpu_torch.scene.gaussians import R_CUT

H = 32    # entries per slice of the JAX solve view (counts s_cap)
# The JAX solve kernel's VMEM bound on the densest cell, in H-entry
# slices; scenes above it take the dense engine in both packages.
S_CAP_MAX = 224
TABLE_COLS = 16


@dataclasses.dataclass
class GridIndex:
    """Grid over a GaussianMixture.

    table       [E', 16] float32: the cell-sorted entry rows (E = n_entries,
                padded to a multiple of H with benign rows).  Columns as in
                ``kernels/pathtrace.pack_table`` except 9, which holds the
                entry's own cell id (exact in float32 below 2^24 cells).
    cell_first  [C] int32 first entry of each cell
    cell_count  [C] int32 entries of each cell (0 = empty)
    lo, cell, inv_cell  [3] float32 grid origin, cell size, 1 / cell size
    side        (sx, sy, sz);  s_cap  the most H-slices one cell spans
    lo_t, cell_t  host copies of lo and cell, the kernels' arguments
    """

    table: torch.Tensor
    cell_first: torch.Tensor
    cell_count: torch.Tensor
    lo: torch.Tensor
    cell: torch.Tensor
    inv_cell: torch.Tensor
    side: tuple
    s_cap: int
    n_entries: int
    lo_t: tuple = ()
    cell_t: tuple = ()

    @property
    def n_cells(self) -> int:
        sx, sy, sz = self.side
        return sx * sy * sz

    @property
    def c_max(self) -> int:
        """Crossing slots per ray: the intervals between the 3*(side+1)
        sorted axis-plane times, padded to an even count as in JAX."""
        r = sum(self.side) + 3
        return r + (r % 2) - 1

    def to(self, device) -> "GridIndex":
        return dataclasses.replace(
            self, **{f: getattr(self, f).to(device) for f in (
                "table", "cell_first", "cell_count", "lo", "cell",
                "inv_cell")})


def _feature_rows(gmm) -> np.ndarray:
    """[N, 16] float32 feature rows (column 9 left for the cell id)."""
    n = gmm.n
    ones = torch.ones((n, 1), dtype=torch.float32, device=gmm.mean.device)
    rows = torch.cat([gmm.icpack(), gmm.qvec(), torch.zeros_like(ones),
                      (gmm.density * gmm.norm)[:, None],
                      gmm.albedo[:, None], ones, gmm.mean], dim=1)
    return rows.cpu().numpy().astype(np.float32)


def _benign_pad_row() -> np.ndarray:
    """Identity quadratic, zero density, valid 0, cell id -1."""
    r = np.zeros(TABLE_COLS, np.float32)
    r[0:3] = 1.0
    r[9] = -1.0
    return r


def _bin_gaussians(i0, i1, sy: int, sz: int):
    """Gaussian -> cell expansion.  i0/i1 [N,3] inclusive cell index
    ranges.  Returns (cell_ids [E], g_ids [E], ixyz [E,3])."""
    spans = i1 - i0 + 1
    dup = spans.prod(axis=1)
    e = int(dup.sum())
    g_ids = np.repeat(np.arange(i0.shape[0], dtype=np.int64), dup)
    start = np.zeros_like(dup)
    start[1:] = np.cumsum(dup)[:-1]
    off = np.arange(e, dtype=np.int64) - np.repeat(start, dup)
    syz = np.repeat(spans[:, 1] * spans[:, 2], dup)
    szz = np.repeat(spans[:, 2], dup)
    ix = np.repeat(i0[:, 0], dup) + off // syz
    iy = np.repeat(i0[:, 1], dup) + (off % syz) // szz
    iz = np.repeat(i0[:, 2], dup) + off % szz
    return (ix * sy + iy) * sz + iz, g_ids, np.stack([ix, iy, iz], axis=1)


# Coordinate descent returns a feasible point, an upper bound on the least
# Mahalanobis distance to the cell box, so the test keeps some slack.
_TIGHT_SLACK = 1.02
_TIGHT_SWEEPS = 8


def _tight_mask(ic6, mean, g_ids, ixyz, lo, cell):
    """Keep a (Gaussian, cell) pair only if the R_CUT ellipsoid meets the
    cell box: the least (x-mu)^T A (x-mu) over the box by cyclic coordinate
    descent (each 1-D step exact, then clipped).  A dropped pair adds
    nothing to any crossing of that cell, so dropping is lossless."""
    A00, A11, A22, A01, A02, A12 = (ic6[g_ids, k] for k in range(6))
    mu = mean[g_ids]
    blo = lo[None, :] + ixyz * cell[None, :]
    bhi = blo + cell[None, :]
    x = np.clip(mu, blo, bhi)
    for _ in range(_TIGHT_SWEEPS):
        x0 = mu[:, 0] - (A01 * (x[:, 1] - mu[:, 1])
                         + A02 * (x[:, 2] - mu[:, 2])) / A00
        x[:, 0] = np.clip(x0, blo[:, 0], bhi[:, 0])
        x1 = mu[:, 1] - (A01 * (x[:, 0] - mu[:, 0])
                         + A12 * (x[:, 2] - mu[:, 2])) / A11
        x[:, 1] = np.clip(x1, blo[:, 1], bhi[:, 1])
        x2 = mu[:, 2] - (A02 * (x[:, 0] - mu[:, 0])
                         + A12 * (x[:, 1] - mu[:, 1])) / A22
        x[:, 2] = np.clip(x2, blo[:, 2], bhi[:, 2])
    dx = x - mu
    m2 = (A00 * dx[:, 0] ** 2 + A11 * dx[:, 1] ** 2 + A22 * dx[:, 2] ** 2
          + 2.0 * (A01 * dx[:, 0] * dx[:, 1] + A02 * dx[:, 0] * dx[:, 2]
                   + A12 * dx[:, 1] * dx[:, 2]))
    return m2 <= (R_CUT * _TIGHT_SLACK) ** 2


# The JAX package's cost model, fitted on the TPU (ns per work-list slot,
# per swept entry lane, per solve slice, per DDA slot).  Kept as it is so
# that both packages choose the same side; refitting it to the H100 is
# open work (PERF.md "Open questions").
C_SORT_SLOT = 4.3
C_LANE = 0.105
C_SOLVE = 6.5
C_DDA = 0.9
H2 = 128  # the TPU span view's slice width, a term of the cost model


def choose_side(bmin, bmax, lo, hi, ic6=None, mean=None) -> int:
    """The grid side (2..24) with the least modelled cost per ray, taken as
    the coarsest side within 12 % of the optimum; sides whose densest
    cell spans more than S_CAP_MAX slices are refused.  The statistics are
    estimated on a subsample of 2,500 Gaussians and at most 300,000
    (Gaussian, cell) pairs per side, as in ``gvr_tpu/accel/grid.py``."""
    n = bmin.shape[0]
    sub_cap = 2500
    scale = 1.0
    if n > sub_cap:
        sel = np.random.default_rng(0).choice(n, sub_cap, replace=False)
        bmin, bmax = bmin[sel], bmax[sel]
        if ic6 is not None:
            ic6, mean = ic6[sel], mean[sel]
        scale = n / sub_cap
    pair_cap = 300_000
    best, best_cost = None, float("inf")
    costs = {}
    fallback, fallback_cap = 2, 10 ** 9
    rising = 0
    for side in range(2, 25):
        cell = (hi - lo) / side
        i0 = np.clip(((bmin - lo) / cell).astype(np.int64), 0, side - 1)
        i1 = np.clip(((bmax - lo) / cell).astype(np.int64), 0, side - 1)
        cell_ids, g_ids, ixyz = _bin_gaussians(i0, i1, side, side)
        scale2 = 1.0
        if cell_ids.shape[0] > pair_cap:
            psel = np.random.default_rng(side).choice(
                cell_ids.shape[0], pair_cap, replace=False)
            scale2 = cell_ids.shape[0] / pair_cap
            cell_ids, g_ids, ixyz = cell_ids[psel], g_ids[psel], ixyz[psel]
        if ic6 is not None:
            cell_ids = cell_ids[_tight_mask(ic6, mean, g_ids, ixyz, lo,
                                            cell)]
        counts = np.bincount(cell_ids, minlength=side ** 3) * (scale * scale2)
        occ = counts > 0
        gend = np.cumsum(counts)
        gfirst = gend - counts
        span_sl = np.where(counts > 0, (gend - 1) // H - gfirst // H + 1, 0)
        s_cap = int(max(span_sl.max(), 1))
        if s_cap < fallback_cap:
            fallback, fallback_cap = side, s_cap
        if s_cap > S_CAP_MAX:
            # a refused side still counts toward the early stop
            rising += 1 if best is not None else 0
            if rising >= 3:
                break
            continue
        occ_crossings = 1.5 * side * occ.mean()
        slots = 3 * side + 3
        aligned_lanes = float(np.mean(
            np.ceil(counts[occ] / H2) * H2)) if occ.any() else float(H2)
        tau_ns = occ_crossings * aligned_lanes * C_LANE
        solve_ns = (span_sl.sum() / max(occ.sum(), 1)) * C_SOLVE
        cost = C_DDA * slots + C_SORT_SLOT * slots + tau_ns + solve_ns
        costs[side] = cost
        if cost < best_cost:
            best, best_cost = side, cost
            rising = 0
        else:
            # stop once the cost has sat >30 % above the best for 3 sides
            rising = rising + 1 if cost > 1.3 * best_cost else 0
            if rising >= 3:
                break
    if best is None:
        return fallback
    for side in sorted(costs):
        if costs[side] <= best_cost * 1.12:
            return side
    return best


def build_grid(gmm, side: int | None = None) -> GridIndex:
    """Host build (numpy, once per scene), on the mixture's device: the
    counterpart of the reference's ``BuildBVH`` (gmm.h:231-260)."""
    bmin, bmax = (a.cpu().numpy().astype(np.float64) for a in gmm.aabbs())
    lo = bmin.min(axis=0) - 1e-4
    hi = bmax.max(axis=0) + 1e-4
    ic6 = gmm.icpack().cpu().numpy().astype(np.float64)
    mean_np = gmm.mean.cpu().numpy().astype(np.float64)
    if side is None:
        side = choose_side(bmin, bmax, lo, hi, ic6, mean_np)
    sides = np.array([side] * 3)
    cell = (hi - lo) / sides.astype(np.float64)
    i0 = np.clip(((bmin - lo) / cell).astype(np.int64), 0, sides - 1)
    i1 = np.clip(((bmax - lo) / cell).astype(np.int64), 0, sides - 1)

    cell_ids, g_ids, ixyz = _bin_gaussians(i0, i1, side, side)
    tight = _tight_mask(ic6, mean_np, g_ids, ixyz, lo, cell)
    cell_ids, g_ids = cell_ids[tight], g_ids[tight]
    counts = np.bincount(cell_ids, minlength=side ** 3).astype(np.int64)
    gfirst = np.zeros_like(counts)
    gfirst[1:] = np.cumsum(counts)[:-1]
    e_total = int(counts.sum())
    gend = gfirst + counts
    span = np.where(counts > 0, (gend - 1) // H - gfirst // H + 1, 0)
    s_cap = int(max(span.max(), 1))

    order = np.argsort(cell_ids, kind="stable")
    n_rows = max(H, ((e_total + H - 1) // H) * H)
    table = np.tile(_benign_pad_row(), (n_rows, 1))
    table[:e_total] = _feature_rows(gmm)[g_ids[order]]
    table[:e_total, 9] = cell_ids[order].astype(np.float32)

    return make_grid(table, gfirst, counts, lo, cell, 1.0 / cell,
                     (side,) * 3, s_cap, e_total, gmm.mean.device)


def make_grid(table, cell_first, cell_count, lo, cell, inv_cell, side,
              s_cap: int, n_entries: int, device) -> GridIndex:
    """GridIndex on ``device`` from numpy arrays (float32 geometry)."""
    f32 = lambda a: np.asarray(a, np.float32)
    t = lambda a, dt: torch.tensor(np.asarray(a, dt), device=device)
    return GridIndex(
        table=t(table, np.float32), cell_first=t(cell_first, np.int32),
        cell_count=t(cell_count, np.int32), lo=t(lo, np.float32),
        cell=t(cell, np.float32), inv_cell=t(inv_cell, np.float32),
        side=tuple(int(s) for s in side), s_cap=int(s_cap),
        n_entries=int(n_entries), lo_t=tuple(float(v) for v in f32(lo)),
        cell_t=tuple(float(v) for v in f32(cell)))


def dda_crossings(grid: GridIndex, origin, direction, tmax=None):
    """t-ordered cell crossings of a ray batch: plain PyTorch, as it is
    plain XLA in the JAX package (``gvr_tpu/accel/grid.py:432``).

    origin/direction [B,3] float32; tmax [B] or None.  Returns (cells
    [B,C] int32, -1 for unused slots; t_in [B,C]; t_out [B,C]), C =
    grid.c_max.  The crossing boundaries are the ray's axis-plane times:
    all 3*(side+1) of them, clipped to [t_enter, t_exit], sorted along the
    boundary axis, and the cells read off the interval midpoints.  A cell
    id repeated by a float32 midpoint sliver is merged into one interval
    [run-head t_in, run-end t_out] and the repeats are dropped, so every
    valid cell of a ray is distinct (K6 integrates a whole cell crossing
    from the cell id alone).  ``torch.sort`` takes the place of JAX's
    odd-even network, and a cumsum over run heads with a per-run max that
    of its unrolled run merge: the same values in about 40 launches (a
    cummax/cummin pair over run-head indices measured 1.36 ms of a 5 ms
    grid iteration on an NVIDIA H100 80GB HBM3 at 700.00 W; PERF.md)."""
    dev = origin.device
    side = torch.tensor(grid.side, dtype=torch.int64, device=dev)
    eps = 1e-12
    d_safe = torch.where(direction.abs() > eps, direction,
                         torch.where(direction >= 0, eps, -eps))
    inv_d = 1.0 / d_safe
    glo = grid.lo
    ghi = grid.lo + grid.cell * side.to(torch.float32)
    ta = (glo - origin) * inv_d
    tb = (ghi - origin) * inv_d
    t_enter = torch.clamp(torch.minimum(ta, tb).amax(dim=-1), min=0.0)
    t_exit = torch.maximum(ta, tb).amin(dim=-1)
    if tmax is not None:
        t_exit = torch.minimum(t_exit, tmax)
    t_exit = torch.maximum(t_exit, t_enter)

    planes = []
    for ax, n_ax in enumerate(grid.side):
        i = torch.arange(n_ax + 1, dtype=torch.float32, device=dev)[None, :]
        planes.append((glo[ax] + i * grid.cell[ax] - origin[:, ax:ax + 1])
                      * inv_d[:, ax:ax + 1])                  # [B, n+1]
    ts = torch.cat(planes, dim=1)
    if ts.shape[1] % 2:
        ts = torch.cat([ts, ts[:, -1:]], dim=1)
    ts = torch.minimum(torch.maximum(ts, t_enter[:, None]), t_exit[:, None])
    ts = torch.sort(ts, dim=1).values

    t_in, t_out = ts[:, :-1], ts[:, 1:]
    mid = origin[:, None, :] + (0.5 * (t_in + t_out))[..., None] \
        * direction[:, None, :]
    idx = torch.minimum(torch.clamp(((mid - glo) * grid.inv_cell)
                                    .to(torch.int64), min=0), side - 1)
    cid = (idx[..., 0] * side[1] + idx[..., 1]) * side[2] + idx[..., 2]

    # merge each run of equal ids: the run's interval is [t_in of its head,
    # the largest t_out of the run] (t_out rises along the row).  The run
    # ids are a scan along the short crossing axis, taken over the
    # transposed [C, B] copy (torch's scan along the innermost axis of a
    # [B, C] tensor measured 0.42 ms a call, the outer-axis one a few us,
    # on an NVIDIA H100 80GB HBM3 at 700.00 W; PERF.md).
    head = torch.ones_like(cid, dtype=torch.bool)
    head[:, 1:] = cid[:, 1:] != cid[:, :-1]
    run = torch.cumsum(head.T, dim=0).T - 1
    rout = torch.zeros_like(t_out).scatter_reduce(
        1, run, t_out, "amax", include_self=False).gather(1, run)
    valid = head & (rout > t_in)
    return (torch.where(valid, cid, -1).to(torch.int32),
            torch.where(valid, t_in, 0.0),
            torch.where(valid, rout, 0.0))
