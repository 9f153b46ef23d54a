"""The big-N dense bounce: the table, the plain versions and the CUDA
kernels K4 (chunk-culled bounce) and K5 (chunk-streamed NEE).

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
``gvr_big_nee`` in ``csrc/kernels.cu``): one thread per ray; K4's blocks
vote on the chunks their rays hit and walk only those in the Newton and
albedo passes.  The source note in ``big.cuh`` says what bounds them.
"""

from __future__ import annotations

import torch

from gvr_tpu_torch.kernels import _build
from gvr_tpu_torch.kernels.pathtrace import (TABLE_COLS, _albedo, _coeffs,
                                             _interval, _li, _nee_ray,
                                             _newton, _pairs, _tau_nee,
                                             pack_table)
from gvr_tpu_torch.ops.solvers import illinois_update_inset
from gvr_tpu_torch.scene.gaussians import GaussianMixture

G = 256                  # Gaussians a chunk
MAX_CHUNKS = 96          # the JAX package's ceiling (24,576 Gaussians)
BLOCK_RAYS = 64          # rays a block of K4 (csrc/big.cuh BIG_BLOCK)
STAGE1_ROWS = 16         # K4's output rows, csrc/big.cuh BigRow
# Bound on the [N, rays] pairs one chunk of a plain version holds:
# ~30 float32 temporaries of this many elements each.
PAIR_BUDGET = 1 << 22


def plan(n_chunks: int) -> int:
    """The chunks a K4 block may list: all of them.  Raises above
    MAX_CHUNKS with the JAX package's advice, so the chunk list can never
    overflow (which is why the TPU kernel's overflow branch is dead)."""
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


def big_stage1(table, o, d, xi, lights, solver_iters: int = 12):
    """K4's [16, B] rows; the arguments of ``big_stage1_reference``.  A CPU
    tensor takes the plain version; a CUDA tensor launches K4 or raises."""
    if table.device.type == "cpu":
        return big_stage1_reference(table, o, d, xi, lights, solver_iters)
    dev = table.device
    b = o.shape[0]
    xi5 = xi[:, :5].contiguous()
    check_big_table(table, dev)
    _build.check(o, "o", torch.float32, (b, 3), dev)
    _build.check(d, "d", torch.float32, (b, 3), dev)
    _build.check(xi5, "xi", torch.float32, (b, 5), dev)
    _build.check(lights, "lights", torch.float32, (None, 6), dev)
    out = torch.empty((STAGE1_ROWS, b), dtype=torch.float32, device=dev)
    _build.launch(
        "gvr_big_stage1", _build.ptr(table), table.shape[0], _build.ptr(o),
        _build.ptr(d), _build.ptr(xi5), b, _build.ptr(lights),
        lights.shape[0], solver_iters, _build.ptr(out), device=dev)
    big_stage1.launches += 1
    return out


big_stage1.launches = 0


def big_nee(table, stage1, env):
    """Li [B,3] from K4's rows; the arguments of ``big_nee_reference``.  A
    CPU tensor takes the plain version; a CUDA tensor launches K5 or
    raises."""
    if table.device.type == "cpu":
        return big_nee_reference(table, stage1, env)
    dev = table.device
    b = stage1.shape[1]
    check_big_table(table, dev)
    _build.check(stage1, "stage1", torch.float32, (STAGE1_ROWS, b), dev)
    _build.check(env, "env", torch.float32, (3,), dev)
    out = torch.empty((3, b), dtype=torch.float32, device=dev)
    _build.launch("gvr_big_nee", _build.ptr(table), table.shape[0],
                  _build.ptr(stage1), b, _build.ptr(env), _build.ptr(out),
                  device=dev)
    big_nee.launches += 1
    return out.T


big_nee.launches = 0


def bounce_step_big(table, o, d, xi, lights, env, solver_iters: int = 12):
    """One bounce through K4 and K5, the contract of the JAX package's
    ``bounce_step_pallas_big``: (t_sc [B], scattered bool [B], albedo [B],
    li [B,3], tau_tot [B]); table from ``pack_rows``."""
    s1 = big_stage1(table, o, d, xi, lights, solver_iters)
    return s1[0], s1[1] > 0.5, s1[2], big_nee(table, s1, env), s1[3]


def culling_stats(table, o, d, block: int = BLOCK_RAYS):
    """What K4's passes walk, in plain torch, for measurements: (chunks
    each block of ``block`` consecutive rays hits [ceil(B / block)], the
    pairs each ray crosses [B]), both int64.  A chunk counts for a block
    when any of its rays crosses any of its Gaussians (K4's vote)."""
    col = lambda f: table[:, f:f + 1]
    step = max(block, (PAIR_BUDGET // table.shape[0]) // block * block)
    hits, crossed = [], []
    for s in range(0, o.shape[0], step):
        ray = [v[s:s + step, k][None, :] for v in (o, d) for k in range(3)]
        ok = _interval(col, *ray, *_coeffs(col, *ray))[3].float()  # [N, b]
        crossed.append(ok.sum(0))
        ok = torch.nn.functional.pad(ok, (0, -ok.shape[1] % block))
        hits.append(ok.reshape(ok.shape[0] // G, G, -1, block)
                    .amax(3).amax(1).sum(0))
    return torch.cat(hits).long(), torch.cat(crossed).long()
