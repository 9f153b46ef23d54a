"""Grid regular tracking: the plain versions and the CUDA kernels K6 (span
tau) and K7 (cell solve).

Replaces ``gvr_tpu/kernels/gridtrace.py:217 span_tau_pass`` (body
``_make_span_tau_kernel`` :93) and ``:425 solve_pass`` (body
``_make_solve_kernel`` :261).

K6, per (ray, cell crossing) slot of the DDA's [R, C] output: the optical
depth of the cell's Gaussians over ray ∩ cell box ∩ [0, tmax].  The
interval is recomputed from the cell box (``gridtrace.py:176-198``), not
taken from the DDA's merged interval, and each Gaussian's erf is taken at
its clipped ends.  Empty slots (cell -1) and empty cells give 0.

K7, per scattered ray: in its critical cell, over the DDA interval
[t_in, t_out], the cell's tau and bracket, ``grid_solver_iters`` steps of
Newton + Illinois toward min(residual, 0.999999 tau_cell), the erfinv
finisher (always on) and the mixture albedo at the root.  A ray whose
cell is -1 or empty gives (0, 0), as the TPU kernel's dead blocks do.

Plain versions (``span_tau_reference``, ``solve_reference``): the TPU
kernels' math on [slots, max cell count] gathers of the table, chunked so
that a 65,536-ray batch fits in device memory.

Kernels (``csrc/grid.cuh`` device functions, ``csrc/kernels.cu``
launchers ``gvr_span_tau`` and ``gvr_grid_solve``): one thread walks a
cell's entries [cell_first, cell_first + cell_count), 64-byte rows, for a
slot (K6) or a ray (K7), behind the division-free pre-test ``may_cross``:
a ray crosses ~2 of a cell's ~120 entries on the 10k grid, so the
pre-test of every entry is most of the work (``span_work`` counts it for
K6's bound).  Neighbouring threads take neighbouring rays, which mostly
share the cell, so a row load is one broadcast to the warp.  K6's block
lists its non-empty slots in shared memory before the walk, so empty
slots (about half of an iteration's) hold no lane of a walking warp.  K7
lists the entries its ray crosses for its later passes.  The TPU work
lists (cell sorts, dummy items, the un-sort) are gone: they avoided
per-item gathers, which are cheap on the GPU.  K7 takes rays in the
caller's order; sorting them by cell first cost more than it saved on the
H100, and so did K6 teams of lanes that pre-test neighbouring rows of one
slot's cell (PERF.md).
"""

from __future__ import annotations

import math

import torch

from gvr_tpu_torch.accel.grid import GridIndex
from gvr_tpu_torch.kernels import _build
from gvr_tpu_torch.kernels.pathtrace import (BIG, SQRT_HALF, _coeffs,
                                             _finisher_root, _interval)
from gvr_tpu_torch.ops.solvers import illinois_update

# Bound on the (slot, entry) pairs one chunk of a plain version gathers:
# ~30 float32 temporaries of this many elements each.
PAIR_BUDGET = 1 << 22


def _cell_rows(grid: GridIndex, cell, k: int):
    """(col, mask): the [m, k] entries of each cell in ``cell`` [m] and
    which of them exist.  col(f) is entry feature f, [m, k]."""
    first = grid.cell_first[cell].long()
    count = grid.cell_count[cell].long()
    j = torch.arange(k, device=cell.device)[None, :]
    mask = j < count[:, None]
    rows = grid.table[torch.where(mask, first[:, None] + j, 0)]
    return (lambda f: rows[..., f]), mask


def _quants(col, ray, t_in, t_out, mask):
    """Clipped-interval pair quantities (``gridtrace.py:52 _quants``) of
    [m, k] pairs; ray = (ox, oy, oz, dx, dy, dz), each [m, 1], and the
    clip [t_in, t_out] [m, 1].  Returns (sa, zoff, peak, pref, erf_lo,
    tau_i, lo, hi, ok), with pref and tau_i 0 where not ok."""
    a, b = _coeffs(col, *ray)
    t0, t1, m2, ok = _interval(col, *ray, a, b)
    lo = torch.maximum(t0, t_in)
    hi = torch.minimum(t1, t_out)
    ok = ok & (hi > lo) & mask
    a_s = torch.clamp(a, min=1e-30)
    sa = torch.sqrt(a_s)
    zoff = b * (0.5 / sa)
    peak = col(10) * torch.exp(-0.5 * m2)
    pref = torch.where(ok, peak * torch.sqrt(math.pi / (2.0 * a_s)), 0.0)
    erf_lo = torch.erf((sa * lo + zoff) * SQRT_HALF)
    erf_hi = torch.erf((sa * hi + zoff) * SQRT_HALF)
    return sa, zoff, peak, pref, erf_lo, pref * (erf_hi - erf_lo), lo, hi, ok


def _cell_box_clip(grid: GridIndex, cell, ray, tmax):
    """ray ∩ cell box ∩ [0, tmax] as (t_lo, t_hi) [m, 1], zero where
    empty (``gridtrace.py:176-198``, the same float32 steps)."""
    _, sy, sz = grid.side
    ixyz = (cell // (sy * sz), (cell // sz) % sy, cell % sz)
    eps = 1e-12
    ts_lo, ts_hi = [], []
    for ax in range(3):
        o, d = ray[ax], ray[3 + ax]
        inv = 1.0 / torch.where(d.abs() > eps, d,
                                torch.where(d >= 0, eps, -eps))
        b0 = grid.lo[ax] + ixyz[ax][:, None].to(o.dtype) * grid.cell[ax]
        t0 = (b0 - o) * inv
        t1 = t0 + grid.cell[ax] * inv
        ts_lo.append(torch.minimum(t0, t1))
        ts_hi.append(torch.maximum(t0, t1))
    t_lo = torch.clamp(torch.maximum(torch.maximum(ts_lo[0], ts_lo[1]),
                                     ts_lo[2]), min=0.0)
    t_hi = torch.minimum(torch.minimum(torch.minimum(ts_hi[0], ts_hi[1]),
                                       ts_hi[2]), tmax)
    m = t_hi > t_lo
    return torch.where(m, t_lo, 0.0), torch.where(m, t_hi, 0.0)


def _chunks(grid: GridIndex, cell_of, n: int):
    """Yield (index range, k) over n items in chunks of at most
    PAIR_BUDGET pairs, k = the largest cell count of the batch."""
    if n == 0:
        return
    k = max(int(grid.cell_count[cell_of].max()), 1)
    step = max(1, PAIR_BUDGET // k)
    for s in range(0, n, step):
        yield slice(s, min(s + step, n)), k


def span_tau_reference(grid: GridIndex, o, d, tmax, cells):
    """Plain version of K6.  o, d [R,3]; tmax [R]; cells [R,C] int32 from
    ``dda_crossings``.  Returns tau [R,C] float32."""
    span_tau_reference.launches += 1
    r, c = cells.shape
    flat = cells.reshape(-1).long()
    tau = torch.zeros(r * c, dtype=o.dtype, device=o.device)
    slot = torch.nonzero(flat >= 0).squeeze(1)
    slot = slot[grid.cell_count[flat[slot]] > 0]
    for part, k in _chunks(grid, flat[slot], slot.shape[0]):
        s = slot[part]
        cell, ray_i = flat[s], s // c
        ray = [v[ray_i][:, None] for v in (*o.T, *d.T)]
        t_in, t_out = _cell_box_clip(grid, cell, ray, tmax[ray_i][:, None])
        col, mask = _cell_rows(grid, cell, k)
        *_, tau_i, _, _, ok = _quants(col, ray, t_in, t_out, mask)
        tau[s] = torch.where(ok, tau_i, 0.0).sum(dim=1)
    return tau.reshape(r, c)


span_tau_reference.launches = 0


def _solve_cell(col, ray, t_in, t_out, resid, mask, solver_iters: int):
    """``gridtrace.py:295-413`` on [m, k] pairs: returns (t_sc, albedo)
    [m, 1]."""
    sa, zoff, peak, pref, erf_lo, tau_i, lo, hi, ok = _quants(
        col, ray, t_in, t_out, mask)
    s_peak = torch.where(ok, peak, 0.0)
    s_lo = torch.where(ok, lo, BIG)
    s_hi = torch.where(ok, hi, 0.0)
    tau_cell = tau_i.sum(dim=1, keepdim=True)
    t_lo = torch.minimum(s_lo.amin(dim=1, keepdim=True), t_out)
    t_hi = torch.maximum(s_hi.amax(dim=1, keepdim=True), t_lo)
    tgt = torch.minimum(resid, tau_cell * 0.999999)

    lo_b, hi_b, flo = t_lo, t_hi, -tgt
    fhi = torch.clamp(tau_cell - tgt, min=1e-12)
    t = 0.5 * (t_lo + t_hi)
    for _ in range(solver_iters):
        z = sa * t + zoff
        seg = torch.where(t >= s_hi, tau_i,
                          pref * (torch.erf(z * SQRT_HALF) - erf_lo))
        seg = torch.where(t > s_lo, seg, 0.0)
        inside = (t >= s_lo) & (t <= s_hi)
        sig = torch.where(inside, s_peak * torch.exp(-0.5 * z * z), 0.0)
        lo_b, hi_b, flo, fhi, t = illinois_update(
            lo_b, hi_b, flo, fhi, t, seg.sum(1, keepdim=True) - tgt,
            sig.sum(1, keepdim=True))
    t_sc = torch.minimum(torch.maximum(t, t_lo), t_hi)

    act = (t_sc > s_lo) & (t_sc < s_hi)
    done = (s_hi > s_lo) & (s_hi <= t_sc)
    pick = lambda x: torch.where(act, x, 0.0).sum(1, keepdim=True)
    t_a, fin = _finisher_root(
        tgt, torch.where(done, tau_i, 0.0).sum(1, keepdim=True),
        act.to(torch.float32).sum(1, keepdim=True),
        torch.where(s_lo > t_sc, s_lo, BIG).amin(1, keepdim=True),
        torch.where(done, s_hi, 0.0).amax(1, keepdim=True),
        pick(sa), pick(zoff), pick(pref), pick(erf_lo), pick(s_lo),
        pick(s_hi))
    t_sc = torch.where(fin, t_a, t_sc)
    t_sc = torch.minimum(torch.maximum(t_sc, t_lo), t_hi)

    z = sa * t_sc + zoff
    inside = (t_sc >= s_lo) & (t_sc <= s_hi)
    rho = torch.where(inside, s_peak * torch.exp(-0.5 * z * z), 0.0)
    s_sum = rho.sum(1, keepdim=True)
    sa_sum = (rho * col(11)).sum(1, keepdim=True)
    albedo = torch.clamp(torch.where(
        s_sum > 1e-25, sa_sum / torch.where(s_sum > 1e-25, s_sum, 1.0),
        0.0), 0.0, 1.0)
    return t_sc, albedo


def solve_reference(grid: GridIndex, o, d, t_in, t_out, resid, cells,
                    solver_iters: int = 6):
    """Plain version of K7.  o, d [B,3]; t_in, t_out, resid [B]; cells [B]
    int32, the critical cell of each ray or -1.  Returns (t_sc [B],
    albedo [B]), 0 for rays without a live cell."""
    solve_reference.launches += 1
    b = cells.shape[0]
    t_sc = torch.zeros(b, dtype=o.dtype, device=o.device)
    albedo = torch.zeros_like(t_sc)
    flat = cells.long()
    idx = torch.nonzero(flat >= 0).squeeze(1)
    idx = idx[grid.cell_count[flat[idx]] > 0]
    for part, k in _chunks(grid, flat[idx], idx.shape[0]):
        i = idx[part]
        col, mask = _cell_rows(grid, flat[i], k)
        ray = [v[i][:, None] for v in (*o.T, *d.T)]
        t, alb = _solve_cell(col, ray, t_in[i][:, None], t_out[i][:, None],
                             resid[i][:, None], mask, solver_iters)
        t_sc[i], albedo[i] = t[:, 0], alb[:, 0]
    return t_sc, albedo


solve_reference.launches = 0


def crossed_entries(grid: GridIndex, o, d, t_in, t_out, cells):
    """The entries of each ray's cell that its interval [t_in, t_out]
    crosses (K7's ok pairs), int64 [B], 0 without a live cell: the pairs
    whose erf/exp K7's passes need, for measurements."""
    n = torch.zeros(cells.shape[0], dtype=torch.int64, device=o.device)
    flat = cells.long()
    idx = torch.nonzero(flat >= 0).squeeze(1)
    idx = idx[grid.cell_count[flat[idx]] > 0]
    for part, k in _chunks(grid, flat[idx], idx.shape[0]):
        i = idx[part]
        col, mask = _cell_rows(grid, flat[i], k)
        ray = [v[i][:, None] for v in (*o.T, *d.T)]
        n[i] = _quants(col, ray, t_in[i][:, None], t_out[i][:, None],
                       mask)[-1].sum(dim=1)
    return n


def span_work(grid: GridIndex, o, d, tmax, cells):
    """The work K6 needs for each slot of ``span_tau_reference``'s
    arguments: (visited, crossed), int64 [R,C].  visited: the entries of
    the slot's cell where ray ∩ cell box ∩ [0, tmax] is not empty (K6
    pre-tests each), 0 for an empty slot, cell or clip; crossed: those
    whose interval meets that clip (a pair test and an evaluation each),
    for measurements."""
    r, c = cells.shape
    flat = cells.reshape(-1).long()
    visited = torch.zeros(r * c, dtype=torch.int64, device=o.device)
    crossed = torch.zeros_like(visited)
    slot = torch.nonzero(flat >= 0).squeeze(1)
    slot = slot[grid.cell_count[flat[slot]] > 0]
    for part, k in _chunks(grid, flat[slot], slot.shape[0]):
        s = slot[part]
        cell, ray_i = flat[s], s // c
        ray = [v[ray_i][:, None] for v in (*o.T, *d.T)]
        t_in, t_out = _cell_box_clip(grid, cell, ray, tmax[ray_i][:, None])
        col, mask = _cell_rows(grid, cell, k)
        visited[s] = torch.where(t_out[:, 0] > t_in[:, 0],
                                 grid.cell_count[cell].long(), 0)
        crossed[s] = _quants(col, ray, t_in, t_out, mask)[-1].sum(dim=1)
    return visited.reshape(r, c), crossed.reshape(r, c)


def check_grid(grid: GridIndex, dev) -> None:
    """The kernels read table rows as float4 and the cell ranges as
    int32."""
    c = grid.n_cells
    _build.check(grid.table, "grid.table", torch.float32, (None, 16), dev)
    if grid.table.data_ptr() % 16:
        raise ValueError("grid.table: data pointer is not 16-byte aligned")
    _build.check(grid.cell_first, "grid.cell_first", torch.int32, (c,), dev)
    _build.check(grid.cell_count, "grid.cell_count", torch.int32, (c,), dev)


def span_tau_pass(grid: GridIndex, o, d, tmax, cells):
    """Per-crossing optical depth [R,C]; the arguments of
    ``span_tau_reference``.  A CPU tensor takes the plain version; a CUDA
    tensor launches K6 or raises."""
    if cells.device.type == "cpu":
        return span_tau_reference(grid, o, d, tmax, cells)
    dev = cells.device
    r, c = cells.shape
    check_grid(grid, dev)
    _build.check(o, "o", torch.float32, (r, 3), dev)
    _build.check(d, "d", torch.float32, (r, 3), dev)
    _build.check(tmax, "tmax", torch.float32, (r,), dev)
    _build.check(cells, "cells", torch.int32, (r, c), dev)
    out = torch.empty((r, c), dtype=torch.float32, device=dev)
    _build.launch(
        "gvr_span_tau", _build.ptr(grid.table), _build.ptr(grid.cell_first),
        _build.ptr(grid.cell_count), *grid.side, *grid.lo_t, *grid.cell_t,
        _build.ptr(o),
        _build.ptr(d), _build.ptr(tmax), _build.ptr(cells), r, c,
        _build.ptr(out), device=dev)
    span_tau_pass.launches += 1
    return out


span_tau_pass.launches = 0


def solve_pass(grid: GridIndex, o, d, t_in, t_out, resid, cells,
               solver_iters: int = 6):
    """(t_sc [B], albedo [B]) in each ray's critical cell; the arguments of
    ``solve_reference``.  A CPU tensor takes the plain version; a CUDA
    tensor launches K7 or raises."""
    if cells.device.type == "cpu":
        return solve_reference(grid, o, d, t_in, t_out, resid, cells,
                               solver_iters)
    dev = cells.device
    b = cells.shape[0]
    check_grid(grid, dev)
    _build.check(o, "o", torch.float32, (b, 3), dev)
    _build.check(d, "d", torch.float32, (b, 3), dev)
    for name, t in (("t_in", t_in), ("t_out", t_out), ("resid", resid)):
        _build.check(t, name, torch.float32, (b,), dev)
    _build.check(cells, "cells", torch.int32, (b,), dev)
    out = torch.empty((2, b), dtype=torch.float32, device=dev)
    _build.launch(
        "gvr_grid_solve", _build.ptr(grid.table),
        _build.ptr(grid.cell_first), _build.ptr(grid.cell_count),
        _build.ptr(o), _build.ptr(d), _build.ptr(t_in), _build.ptr(t_out),
        _build.ptr(resid), _build.ptr(cells), b, solver_iters,
        _build.ptr(out), device=dev)
    solve_pass.launches += 1
    return out[0], out[1]


solve_pass.launches = 0
