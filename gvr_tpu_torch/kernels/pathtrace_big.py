"""The big-N dense bounce: the table, the chunk boxes, the plain versions
and the CUDA kernels K4 (box-culled bounce) and K5 (box-culled NEE).

Replaces ``gvr_tpu/kernels/pathtrace_big.py:374 _big_call``: its stage 1
(pallas_call :384, body ``_make_kernel`` :98) and its NEE stage (:409,
body ``_make_nee_kernel`` :283), behind ``bounce_step_pallas_big`` :432.
The dense engine takes them above MEGA_MAX_GAUSSIANS Gaussians, up to 96
chunks of G = 256 Morton-sorted Gaussians (``plan``); larger scenes belong
to the grid engine.

Per ray, K4 computes every pair's clipped 3-sigma interval and closed-form
erf optical depth, tau_tot and the bracket [t_lo, t_hi], the scatter test
against -log(1-u), ``solver_iters`` steps of its own Newton + Illinois
(``ops/solvers.illinois_update_inset``: the falsi point inset 5 % from the
bracket ends, no finite test, no erfinv finisher), the mixture albedo at
the root and the NEE ray (the env with probability 1/(L+1), else light
floor(u L)).  K5 integrates the NEE ray's optical depth up to its tmax and
returns Li = exp(-tau) * (4 pi env, or the light's radiance / d^2).

Plain versions (``big_stage1_reference``, ``big_nee_reference``): that
math on [N, B] tensors with torch.erf (the TPU kernel's A&S erf is within
1.5e-7 of it), chunked over rays so a 65,536-ray batch fits on the card.
Kernels (``csrc/big.cuh``, launchers ``gvr_big_stage1`` and
``gvr_big_nee`` in ``csrc/kernels.cu``): one warp per ray.  Its lanes test
the ray against every chunk's box and, in an admitted chunk, against its
eight 32-row groups' boxes (``chunk_boxes``: the union of the Gaussians'
3-sigma AABBs, widened; ``chunk_box_hits_reference`` is that test in
plain torch), then walk the admitted groups a row a lane, where a
division-free pre-test (``may_cross_reference``) spares most rows the
pair test.  K4's first pass lists the pairs its ray crosses, a pair a
lane, and its Newton and albedo passes walk only those (the groups that
held them where a ray crosses more than MAX_HITS).  Every sum is taken
in row order, so both give the bits of a sweep over every row, and the
plain versions' results, as every pair they skip adds 0.  The source note
in ``big.cuh`` says what bounds them.  ``bind_big_stage1`` and
``bind_big_nee`` bind a launch once to a chunk's buffers for the big-N
loop, whose live count stays on the card, where the kernels read it.
"""

from __future__ import annotations

import torch

from gvr_tpu_torch.kernels import _build
from gvr_tpu_torch.kernels.pathtrace import (BIG, TABLE_COLS, _albedo,
                                             _coeffs, _interval, _li,
                                             _nee_ray, _newton, _pairs,
                                             _tau_nee, pack_table)
# the kernels' pre-test, shared with K1/K2 and kept importable from here
from gvr_tpu_torch.kernels.pathtrace import may_cross_reference  # noqa: F401
from gvr_tpu_torch.ops.solvers import illinois_update_inset
from gvr_tpu_torch.scene.gaussians import GaussianMixture

G = 256                  # Gaussians a chunk
GROUP = 32               # Gaussians a group, the finer box (BIG_GROUP)
MAX_CHUNKS = 96          # the JAX package's ceiling (24,576 Gaussians)
MAX_HITS = 32            # K4's crossed-pair list (csrc/big.cuh BIG_MAX_HITS)
STAGE1_ROWS = 16         # K4's output rows, csrc/big.cuh BigRow
BOX_COLS = 8             # a box: min x y z, pad, max x y z, pad
# A box is widened by BOX_REL of its largest extent plus BOX_ABS of
# its largest |coordinate| (at least 1): far above the float32 rounding of
# the slab test and of the pair test it stands in for, so the cull stays
# conservative (tests/test_torch_big.py holds it so).
BOX_REL, BOX_ABS = 1e-3, 1e-4
EMPTY_BOX = 1e30         # a box without a Gaussian: min 1e30, max -1e30
# Bound on the [N, rays] pairs one chunk of a plain version holds:
# ~30 float32 temporaries of this many elements each.
PAIR_BUDGET = 1 << 22


def plan(n_chunks: int) -> int:
    """The chunks K4 and K5 walk: all of them, each culled by its box.
    Raises above MAX_CHUNKS with the JAX package's advice, so K4's chunk
    mask holds every chunk (which is why the TPU kernel's overflow branch
    is dead)."""
    if n_chunks > MAX_CHUNKS:
        raise ValueError(
            f"chunk-streaming kernel supports at most {MAX_CHUNKS * G} "
            f"gaussians ({n_chunks} chunks requested); use engine='grid'")
    return max(n_chunks, 1)


def n_chunks_for(n: int) -> int:
    return max(1, -(-n // G))


def pack_rows(gmm: GaussianMixture) -> torch.Tensor:
    """[Np, 16] contiguous table as the kernels read it, Np = N rounded
    up to a multiple of G (at most MAX_CHUNKS chunks): pack_table's
    columns, padding rows with icpack 1,1,1 and valid 0.  Built once per
    render."""
    n = gmm.n
    tab = torch.zeros((plan(n_chunks_for(n)) * G, TABLE_COLS),
                      dtype=torch.float32, device=gmm.mean.device)
    tab[:, 0:3] = 1.0
    tab[:n] = pack_table(gmm)[:n]
    return tab


def pack_table_t(gmm: GaussianMixture) -> torch.Tensor:
    """[16, Np]: ``pack_rows`` in the JAX package's transposed layout."""
    return pack_rows(gmm).T


def check_big_table(table: torch.Tensor, dev) -> None:
    """[Np, 16] float32 on ``dev``, contiguous, 16-byte aligned, Np a
    multiple of G and at most MAX_CHUNKS chunks."""
    _build.check(table, "table", torch.float32, (None, TABLE_COLS), dev)
    if table.data_ptr() % 16:
        raise ValueError("table: data pointer is not 16-byte aligned")
    rows = table.shape[0]
    if rows == 0 or rows % G:
        raise ValueError(f"table: {rows} rows, not a positive multiple of "
                         f"{G}")
    plan(rows // G)


def _union_boxes(lo, hi, rows: int) -> torch.Tensor:
    """[K, 8] boxes of consecutive ``rows``-row blocks of the per-row
    boxes lo, hi [K * rows, 3] (padding rows +inf, -inf), widened."""
    lo = lo.view(-1, rows, 3).amin(1)
    hi = hi.view(-1, rows, 3).amax(1)
    scale = torch.maximum(lo.abs(), hi.abs()).amax(1, keepdim=True)
    margin = (BOX_REL * (hi - lo).amax(1, keepdim=True)
              + BOX_ABS * torch.clamp(scale, min=1.0))
    empty = ~torch.isfinite(lo).all(1, keepdim=True)
    boxes = torch.zeros((lo.shape[0], BOX_COLS), dtype=lo.dtype,
                        device=lo.device)
    boxes[:, 0:3] = torch.where(empty, EMPTY_BOX, lo - margin)
    boxes[:, 4:7] = torch.where(empty, -EMPTY_BOX, hi + margin)
    return boxes


def chunk_boxes(gmm: GaussianMixture) -> torch.Tensor:
    """[Np / G, 9, 8] float32 boxes of ``pack_rows``' chunks: for each
    chunk its box, then the boxes of its eight GROUP-row groups, each min
    x, y, z, 0, max x, y, z, 0.  A box is the union of ``gmm.aabbs()``
    (the R_CUT-sigma boxes) over its Gaussians, widened by the margin of
    BOX_REL and BOX_ABS; padding rows are left out, and a chunk or group
    with no Gaussian gets an empty box (EMPTY_BOX) that every ray misses.
    Built once per render, beside ``pack_rows``."""
    n_c = plan(n_chunks_for(gmm.n))
    f32 = dict(dtype=torch.float32, device=gmm.mean.device)
    lo = torch.full((n_c * G, 3), float("inf"), **f32)
    hi = torch.full((n_c * G, 3), float("-inf"), **f32)
    if gmm.n:
        lo[:gmm.n], hi[:gmm.n] = gmm.aabbs()
    return torch.cat([_union_boxes(lo, hi, G)[:, None],
                      _union_boxes(lo, hi, GROUP).view(n_c, G // GROUP,
                                                       BOX_COLS)], dim=1)


def check_chunk_boxes(boxes, table: torch.Tensor, dev) -> None:
    """[Np / G, 9, 8] float32 on ``dev`` (``chunk_boxes`` of the scene
    whose ``pack_rows`` is ``table``), contiguous, 16-byte aligned."""
    if boxes is None:
        raise ValueError("boxes: the kernels need chunk_boxes() of the "
                         "scene")
    _build.check(boxes, "boxes", torch.float32,
                 (table.shape[0] // G, 1 + G // GROUP, BOX_COLS), dev)
    if boxes.data_ptr() % 16:
        raise ValueError("boxes: data pointer is not 16-byte aligned")


def chunk_box_hits_reference(boxes, o, d, tmax=None) -> torch.Tensor:
    """The kernels' box test in plain torch: [B, K] bool, whether the
    segment [0, tmax] of each ray (o, d [B,3]; tmax [B], or None for
    [0, inf)) meets each box of ``boxes`` [K, 8].  The same float32
    operations as ``csrc/big.cuh`` ``box_admits``, so the same answers bit
    for bit: per axis the slab's entry and exit times (lo - o) / d and
    (hi - o) / d, ordered by the sign of 1/d; an axis with |d| < 1e-30
    admits every t if the origin lies in the slab and none otherwise."""
    lo, hi = boxes[None, :, 0:3], boxes[None, :, 4:7]       # [1, K, 3]
    o, d = o[:, None, :], d[:, None, :]                     # [B, 1, 3]
    flat = d.abs() < 1e-30
    inv = 1.0 / torch.where(flat, 1.0, d)
    ta, tb = (lo - o) * inv, (hi - o) * inv                 # [B, K, 3]
    pos = inv >= 0.0
    near = torch.where(flat, 0.0, torch.where(pos, ta, tb))
    far = torch.where(flat, torch.where((o >= lo) & (o <= hi),
                                        float("inf"), -BIG),
                      torch.where(pos, tb, ta)).amin(-1)
    if tmax is not None:
        far = torch.minimum(far, tmax[:, None])
    return torch.clamp(near.amax(-1), min=0.0) <= far


def admitted_reference(boxes, o, d, tmax=None):
    """What the kernels' box tests admit, in plain torch: (chunks [B,
    n_chunks] bool, groups [B, n_chunks, 8] bool, a group counting only in
    an admitted chunk, as the kernels test it only there)."""
    chunks = chunk_box_hits_reference(boxes[:, 0], o, d, tmax)
    groups = chunk_box_hits_reference(boxes[:, 1:].reshape(-1, BOX_COLS),
                                      o, d, tmax).view(chunks.shape + (-1,))
    return chunks, groups & chunks[..., None]


def admitted_counts_reference(boxes, o, d, tmax=None) -> torch.Tensor:
    """[2, B] int32: the chunks and the groups each ray's box tests admit
    (``admitted_reference``), as the kernels count them."""
    chunks, groups = admitted_reference(boxes, o, d, tmax)
    return torch.stack([chunks.sum(1), groups.sum((1, 2))]).int()


def _by_rays(table, b: int, fn):
    """fn(slice) over ray chunks of at most PAIR_BUDGET pairs, joined on
    the last axis."""
    step = max(1, PAIR_BUDGET // table.shape[0])
    return torch.cat([fn(slice(s, min(s + step, b)))
                      for s in range(0, b, step)], dim=-1)


def big_stage1_reference(table, o, d, xi, lights, solver_iters: int = 12):
    """Plain version of K4.  table [Np,16] (``pack_rows``); o, d [B,3];
    xi [B,>=5] uniforms (target, NEE choice, light index, env direction
    x2); lights [L,6].  Returns [16, B]: t_sc, scattered, albedo, tau_tot,
    the NEE ray's origin (3) and direction (3), tmax, is_env, the light's
    radiance (3) and 1/d^2."""
    big_stage1_reference.launches += 1
    col = lambda f: table[:, f:f + 1]                      # [N, 1]

    def rays(s):
        ray = [v[s, k][None, :] for v in (o, d) for k in range(3)]
        u_tau, u_nee, u_light, u_env1, u_env2 = (xi[s, k][None, :]
                                                 for k in range(5))
        pairs = _pairs(col, *ray)
        tau_tot = pairs[5].sum(dim=0, keepdim=True)        # [1, b]
        t_hi = pairs[7].amax(dim=0, keepdim=True)
        t_lo = torch.minimum(pairs[6].amin(dim=0, keepdim=True), t_hi)
        target = -torch.log(torch.clamp(1.0 - u_tau, min=1e-12))
        scattered = tau_tot > target
        tgt = torch.minimum(target, tau_tot * 0.999999)
        t_sc = _newton(pairs, tau_tot, t_lo, t_hi, tgt, solver_iters,
                       illinois_update_inset)
        p, w, tmax, is_env, rad, inv_d2 = _nee_ray(
            ray, t_sc, u_nee, u_light, u_env1, u_env2, lights)
        return torch.cat([t_sc, scattered.float(), _albedo(col, pairs, t_sc),
                          tau_tot, *p, *w, tmax, is_env.float(),
                          rad.reshape(3, -1), inv_d2])

    return _by_rays(table, o.shape[0], rays)


big_stage1_reference.launches = 0


def big_nee_reference(table, stage1, env):
    """Plain version of K5: Li [B,3] of stage 1's NEE rays ([16, B])."""
    big_nee_reference.launches += 1
    col = lambda f: table[:, f:f + 1]

    def rays(s):
        r = stage1[:, s]
        tr = torch.exp(-_tau_nee(col, *(r[k:k + 1] for k in range(4, 11))))
        return _li(tr, r[11:12] > 0.5, r[12:15], r[15:16], env).T

    return _by_rays(table, stage1.shape[1], rays).T


big_nee_reference.launches = 0


def _admitted_out(admitted, b: int, dev):
    if admitted is not None:
        _build.check(admitted, "admitted", torch.int32, (2, b), dev)
    return admitted


def _stage1_tail(table, o, d, xi, lights, solver_iters, boxes, out,
                 admitted, overflow) -> tuple:
    """``gvr_big_stage1``'s arguments after (n, count), checked: rays o,
    d [b, 3] and xi [b, 5], out [16, b]."""
    dev = table.device
    b = o.shape[0]
    check_big_table(table, dev)
    _build.check(o, "o", torch.float32, (b, 3), dev)
    _build.check(d, "d", torch.float32, (b, 3), dev)
    _build.check(xi, "xi", torch.float32, (b, 5), dev)
    _build.check(lights, "lights", torch.float32, (None, 6), dev)
    check_chunk_boxes(boxes, table, dev)
    _build.check(out, "out", torch.float32, (STAGE1_ROWS, b), dev)
    if overflow is not None:
        _build.check(overflow, "overflow", torch.int32, (1,), dev)
    return (table, table.shape[0], boxes, o, d, xi, b, lights,
            lights.shape[0], solver_iters, out,
            _admitted_out(admitted, b, dev), overflow)


def big_stage1(table, o, d, xi, lights, solver_iters: int = 12, boxes=None,
               admitted=None, overflow=None):
    """K4's [16, B] rows; the arguments of ``big_stage1_reference``, and
    ``boxes``, the scene's ``chunk_boxes``, which the kernel needs.  A CPU
    tensor takes the plain version (which needs no boxes); a CUDA tensor
    launches K4 or raises.  ``admitted``, an int32 [2, B] tensor if
    given, receives the chunks and the groups each ray's box tests
    admitted (on the CPU from ``admitted_counts_reference``).
    ``overflow``, an int32 [1] tensor if given, is incremented by the rays
    that cross more than MAX_HITS pairs, whose passes recompute their
    pairs (on the CPU from ``culling_stats``' 'crossed')."""
    if table.device.type == "cpu":
        if admitted is not None:
            admitted.copy_(admitted_counts_reference(boxes, o, d))
        if overflow is not None:
            overflow += (culling_stats(table, boxes, o, d)["crossed"]
                         > MAX_HITS).sum().int()
        return big_stage1_reference(table, o, d, xi, lights, solver_iters)
    b = o.shape[0]
    out = torch.empty((STAGE1_ROWS, b), dtype=torch.float32,
                      device=table.device)
    _build.launch("gvr_big_stage1", b, None,
                  *_stage1_tail(table, o, d, xi[:, :5].contiguous(), lights,
                                solver_iters, boxes, out, admitted,
                                overflow), device=table.device)
    big_stage1.launches += 1
    return out


big_stage1.launches = 0


def bind_big_stage1(table, o, d, xi, lights, solver_iters: int, boxes,
                    overflow=None):
    """K4 for a loop whose live list stays on the card, bound once to the
    chunk's buffers of B rays (o, d [B, 3], xi [B, 5]).  Returns (``k4(n,
    count)``, out): each call traces rays 0 .. *count - 1 into the first
    columns of out [16, B], count a device pointer (int) to an int32 and
    n >= it sizing the grid; ``overflow`` as for ``big_stage1``.  Each
    call counts in ``big_stage1.launches``."""
    out = torch.empty((STAGE1_ROWS, o.shape[0]), dtype=torch.float32,
                      device=table.device)
    call = _build.bind("gvr_big_stage1",
                       *_stage1_tail(table, o, d, xi, lights, solver_iters,
                                     boxes, out, None, overflow),
                       device=table.device)

    def k4(n: int, count: int) -> None:
        call(n, count)
        big_stage1.launches += 1

    return k4, out


def _nee_tail(table, stage1, env, boxes, out, admitted) -> tuple:
    """``gvr_big_nee``'s arguments after (n, count), checked: K4's rows
    [16, b], out [3, b]."""
    dev = table.device
    b = stage1.shape[1]
    check_big_table(table, dev)
    _build.check(stage1, "stage1", torch.float32, (STAGE1_ROWS, b), dev)
    _build.check(env, "env", torch.float32, (3,), dev)
    check_chunk_boxes(boxes, table, dev)
    _build.check(out, "out", torch.float32, (3, b), dev)
    return (table, table.shape[0], boxes, stage1, b, env, out,
            _admitted_out(admitted, b, dev))


def big_nee(table, stage1, env, boxes=None, admitted=None):
    """Li [B,3] from K4's rows; the arguments of ``big_nee_reference``, and
    ``boxes`` and ``admitted`` as for ``big_stage1`` (each NEE segment's
    box tests over [0, tmax]).  A CPU tensor takes the plain version; a CUDA
    tensor launches K5 or raises."""
    if table.device.type == "cpu":
        if admitted is not None:
            admitted.copy_(admitted_counts_reference(
                boxes, stage1[4:7].T, stage1[7:10].T, stage1[10]))
        return big_nee_reference(table, stage1, env)
    b = stage1.shape[1]
    out = torch.empty((3, b), dtype=torch.float32, device=table.device)
    _build.launch("gvr_big_nee", b, None,
                  *_nee_tail(table, stage1, env, boxes, out, admitted),
                  device=table.device)
    big_nee.launches += 1
    return out.T


big_nee.launches = 0


def bind_big_nee(table, stage1, env, boxes):
    """K5 for a loop whose live list stays on the card, bound once to K4's
    rows ``stage1`` [16, B].  Returns (``k5(n, count)``, out): each call
    writes Li of rays 0 .. *count - 1 into the first columns of out
    [3, B], (n, count) as ``bind_big_stage1``'s.  Each call counts in
    ``big_nee.launches``."""
    out = torch.empty((3, stage1.shape[1]), dtype=torch.float32,
                      device=table.device)
    call = _build.bind("gvr_big_nee",
                       *_nee_tail(table, stage1, env, boxes, out, None),
                       device=table.device)

    def k5(n: int, count: int) -> None:
        call(n, count)
        big_nee.launches += 1

    return k5, out


def bounce_step_big(table, o, d, xi, lights, env, solver_iters: int = 12,
                    boxes=None, overflow=None):
    """One bounce through K4 and K5, the contract of the JAX package's
    ``bounce_step_pallas_big``: (t_sc [B], scattered bool [B], albedo [B],
    li [B,3], tau_tot [B]); table from ``pack_rows``, boxes (needed on the
    card) from ``chunk_boxes``; ``overflow`` as for ``big_stage1``."""
    s1 = big_stage1(table, o, d, xi, lights, solver_iters, boxes,
                    overflow=overflow)
    return s1[0], s1[1] > 0.5, s1[2], big_nee(table, s1, env, boxes), s1[3]


def culling_stats(table, boxes, o, d, tmax=None) -> dict:
    """What K4 (``tmax`` None: each ray over [0, inf)) or K5 (each segment
    [0, tmax]) walks, in plain torch, for measurements; int64 tensors [B]:
    'admitted' and 'groups' the chunks and the groups each ray's box tests
    admit; 'hit' the chunks that hold a pair the ray crosses; 'crossed'
    those pairs (with tmax, the pairs whose interval starts before it)."""
    col = lambda f: table[:, f:f + 1]
    n_c = table.shape[0] // G
    step = max(1, PAIR_BUDGET // table.shape[0])
    keys = ("admitted", "groups", "hit", "crossed")
    out = {k: [] for k in keys}
    for s in range(0, o.shape[0], step):
        sl = slice(s, s + step)
        ray = [v[sl, k][None, :] for v in (o, d) for k in range(3)]
        t0, t1, _, ok = _interval(col, *ray, *_coeffs(col, *ray))  # [N, b]
        tm = None if tmax is None else tmax[sl]
        if tm is not None:
            ok = ok & (torch.minimum(t1, tm[None, :]) > t0)
        out["crossed"].append(ok.sum(0))
        out["hit"].append(ok.reshape(n_c, G, -1).any(1).sum(0))
        chunks, groups = admitted_reference(boxes, o[sl], d[sl], tm)
        groups = groups.flatten(1)
        out["admitted"].append(chunks.sum(1))
        out["groups"].append(groups.sum(1))
    return {k: torch.cat(v).long() for k, v in out.items()}
