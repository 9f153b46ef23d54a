"""The dense wavefront's per-lane glue: the plain version and the CUDA
kernel K8 (two launches an iteration).

It replaces no TPU kernel.  ``integrators/multiscatter._wavefront`` (the
step and XLA engines' loop) and ``_big_wavefront`` (the big-N engine's)
run one lane per pixel of a chunk; each iteration, around one bounce of
the live lanes, they

* before the bounce (``wave_pre``): starts the next sample of a lane
  whose path ended, draws the jitter pair and the bounce's 9 uniforms at
  (pixel, sample, bounce), makes the new sample's stratified camera ray,
  and gathers the live lanes' rays and draws for the bounce;
* after it (``wave_post``): scatters the bounce's results back by lane,
  adds the escape and NEE terms, plays Russian roulette (``roulette``),
  moves a surviving path to its scatter point and turns it, and says which
  lanes have a path to trace next (the mask of the next live read).

``bind_wave_pre`` and ``bind_wave_post`` bind the two launches once a
chunk for the big-N loop, whose live list and its count stay on the card:
the kernels read the count there, and post appends the next list
(``csrc/wave.cuh``, list mode).

The JAX package leaves this to XLA, which fuses it.  In eager PyTorch it
was ~115 small launches an iteration, which the host took longer to
enqueue than the card took to trace the bounce (PERF.md).  K8
(``csrc/wave.cuh``, launchers ``gvr_wave_pre`` and ``gvr_wave_post`` in
``csrc/kernels.cu``) does each half in one launch; the source note there
says what bounds it (bytes of lane state) and how it is laid out.  Its
float arithmetic is the eager loop's, rounding for rounding, so the image
on the card is the plain version's bit for bit.

Plain versions (``wave_pre_reference``, ``wave_post_reference``): the
same glue in eager PyTorch over every lane, the CPU path and the
reference.  A CPU tensor takes them; a CUDA tensor launches K8 or
raises.
"""

from __future__ import annotations

import ctypes
import dataclasses

import torch

from gvr_tpu_torch.cameras import PinholeCamera
from gvr_tpu_torch.kernels import _build
from gvr_tpu_torch.kernels.megatrace import (INV_4PI, camera_vector, strat_n,
                                             strat_uv)
from gvr_tpu_torch.kernels.rng import BOUNCE_DRAWS, seed_words, wave_uniforms
from gvr_tpu_torch.ops.sampling import dir_from_xi

# draws of a bounce that the bounce reads (free flight, NEE choice, NEE
# light, NEE env direction), lane-major [n, XI_BOUNCE]; the others (RR,
# the scattered direction, the uniform solver's) go in planes
XI_BOUNCE = 5


@dataclasses.dataclass
class Lanes:
    """The lanes of one wavefront chunk, one a pixel id, and the camera
    that starts their samples.  The plain versions rebind the fields; the
    kernels write them in place."""
    ids: torch.Tensor      # int32 [B]
    camera: object         # PinholeCamera or OrthographicCamera
    cam: torch.Tensor      # its camera_vector [16]
    o: torch.Tensor        # float32 [B, 3]
    d: torch.Tensor
    thr: torch.Tensor      # throughput
    acc: torch.Tensor      # radiance summed over the lane's samples
    alive: torch.Tensor    # bool [B]: a path is being traced
    sample: torch.Tensor   # int32 [B]: samples started
    bounce: torch.Tensor   # int32 [B]
    slot: torch.Tensor     # int32 [B]: a live lane's place in the batch
    want: torch.Tensor     # bool [B]: the kernel's mask of lanes to trace


def lanes(ids: torch.Tensor, camera) -> Lanes:
    """Fresh lanes for pixel ids [B] (int32): no path, no sample yet."""
    dev = ids.device
    b = ids.shape[0]
    f32 = dict(dtype=torch.float32, device=dev)
    i32 = dict(dtype=torch.int32, device=dev)
    return Lanes(ids=ids, camera=camera, cam=camera_vector(camera),
                 o=torch.zeros((b, 3), **f32), d=torch.ones((b, 3), **f32),
                 thr=torch.ones((b, 3), **f32),
                 acc=torch.zeros((b, 3), **f32),
                 alive=torch.zeros(b, dtype=torch.bool, device=dev),
                 sample=torch.zeros(b, **i32), bounce=torch.zeros(b, **i32),
                 slot=torch.zeros(b, **i32),
                 want=torch.empty(b, dtype=torch.bool, device=dev))


def roulette(cfg, thr, albedo, bounce, xi_rr):
    """(throughput, killed) after the albedo and Russian roulette from
    min_scatter bounces on, survival min(max(throughput), cap), the cap
    rr_cap_tail from rr_tail_after on (integrator.h:688-695); ``bounce``
    an int or an int tensor [B].  K1 and K8 run ``csrc/path.cuh``
    roulette."""
    thr_n = thr * albedo[:, None]
    do_rr = torch.as_tensor(bounce >= cfg.min_scatter, device=thr.device)
    rr_cap = torch.where(
        torch.as_tensor(bounce >= cfg.rr_tail_after, device=thr.device),
        cfg.rr_cap_tail, cfg.rr_cap).to(torch.float32)
    rr = torch.minimum(thr_n.amax(dim=-1), rr_cap)
    killed = do_rr & (xi_rr > rr)
    thr_n = torch.where((do_rr & ~killed)[:, None],
                        thr_n / torch.clamp(rr, min=1e-12)[:, None], thr_n)
    return thr_n, killed


def wave_pre_reference(lanes: Lanes, live: torch.Tensor, cfg):
    """Plain version of K8's first launch: regenerate, draw, shoot the
    new samples' camera rays over every lane, then gather the live lanes'
    (o [n, 3], d [n, 3], xi [n, XI_BOUNCE], the other draws [4, n])."""
    wave_pre_reference.launches += 1
    L = lanes
    w, h, spp = cfg.width, cfg.height, cfg.spp
    regen = ~L.alive & (L.sample < spp)
    L.bounce = torch.where(regen, 0, L.bounce)
    L.sample = torch.where(regen, L.sample + 1, L.sample)
    # the draws keyed by each lane's current sample (the new one where
    # regen): the jitter pair, used where regen, then xi [9, B]
    s_cur = torch.clamp(L.sample, min=1) - 1
    jit, xi = wave_uniforms(L.ids, s_cur, L.bounce, cfg.seed).split(
        [2, BOUNCE_DRAWS])
    u, v = strat_uv(L.ids % w, L.ids // w, s_cur, strat_n(spp), w, h,
                    jit[0], jit[1])
    o_n, d_n = L.camera.sample_ray(torch.stack([u, v], dim=-1))
    L.o = torch.where(regen[:, None], o_n, L.o)
    L.d = torch.where(regen[:, None], d_n, L.d)
    L.thr = torch.where(regen[:, None], 1.0, L.thr)
    L.alive = L.alive | regen
    return (L.o[live], L.d[live], xi[:XI_BOUNCE, live].T,
            xi[XI_BOUNCE:, live])


wave_pre_reference.launches = 0


def wave_post_reference(lanes: Lanes, live: torch.Tensor, xr, res,
                        w_ne: float, env: torch.Tensor, cfg) -> torch.Tensor:
    """Plain version of K8's second launch: the bounce's results ``res``
    (t_sc, scattered, albedo, li of the live lanes) and the draws ``xr``
    [4, n] scattered back by ``live`` (0 elsewhere), then the escape and
    NEE terms, roulette and the next ray over every lane.  Returns the
    lanes with a path to trace next (bool [B])."""
    wave_post_reference.launches += 1
    L = lanes
    b, dev = L.ids.shape[0], L.ids.device
    t_sc, scattered, albedo, li, xi = (
        torch.zeros((b,) + r.shape[1:], dtype=r.dtype, device=dev)
        .index_copy_(0, live, r) for r in (*res, xr.T))
    L.acc = L.acc + torch.where((L.alive & ~scattered)[:, None],
                                L.thr * env, 0.0)
    alive_n = L.alive & scattered
    pos = L.o + t_sc[:, None] * L.d
    L.acc = L.acc + torch.where(
        alive_n[:, None],
        L.thr * (albedo * INV_4PI * w_ne)[:, None] * li, 0.0)
    thr_n, killed = roulette(cfg, L.thr, albedo, L.bounce, xi[:, 0])
    L.alive = alive_n & ~killed & (L.bounce + 1 < cfg.max_bounces)
    L.o = torch.where(L.alive[:, None], pos, L.o)
    L.d = torch.where(L.alive[:, None], dir_from_xi(xi[:, 1:3]), L.d)
    L.thr = torch.where(L.alive[:, None], thr_n, L.thr)
    L.bounce = L.bounce + 1
    return L.alive | (L.sample < cfg.spp)


wave_post_reference.launches = 0


def _check_lanes(L: Lanes) -> None:
    dev, b = L.ids.device, L.ids.shape[0]
    _build.check(L.ids, "ids", torch.int32, (b,), dev)
    _build.check(L.cam, "cam", torch.float32, (16,), dev)
    for name in ("o", "d", "thr", "acc"):
        _build.check(getattr(L, name), name, torch.float32, (b, 3), dev)
    for name in ("sample", "bounce", "slot"):
        _build.check(getattr(L, name), name, torch.int32, (b,), dev)
    for name in ("alive", "want"):
        _build.check(getattr(L, name), name, torch.bool, (b,), dev)


def _pre_tail(L: Lanes, cfg, out, stride: int) -> tuple:
    """``gvr_wave_pre``'s arguments after (live, n, count)."""
    seed_mix, seed_raw = seed_words(cfg.seed)
    return (stride, L.ids, L.cam, cfg.width, cfg.height, strat_n(cfg.spp),
            int(isinstance(L.camera, PinholeCamera)), cfg.spp,
            ctypes.c_uint32(seed_mix), ctypes.c_uint32(seed_raw), L.o, L.d,
            L.thr, L.alive, L.sample, L.bounce, L.slot, *out)


def _pre_out(n: int, dev) -> tuple:
    """Empty (o [n, 3], d [n, 3], xi [n, XI_BOUNCE], the other draws
    [4, n])."""
    f32 = dict(dtype=torch.float32, device=dev)
    return (torch.empty((n, 3), **f32), torch.empty((n, 3), **f32),
            torch.empty((n, XI_BOUNCE), **f32),
            torch.empty((BOUNCE_DRAWS - XI_BOUNCE, n), **f32))


def wave_pre(lanes: Lanes, live: torch.Tensor, cfg):
    """The live lanes' (o [n, 3], d [n, 3], xi [n, XI_BOUNCE], the other
    draws [4, n]) for the bounce, after regeneration; ``live`` the int64
    lane indices of the last live read, in lane order.  A CPU tensor takes
    the plain version; a CUDA tensor launches K8's first kernel or
    raises."""
    L = lanes
    if L.ids.device.type == "cpu":
        return wave_pre_reference(L, live, cfg)
    dev = L.ids.device
    n = live.shape[0]
    _check_lanes(L)
    _build.check(live, "live", torch.int64, (n,), dev)
    out = _pre_out(n, dev)
    _build.launch("gvr_wave_pre", live, n, None, *_pre_tail(L, cfg, out, n),
                  device=dev)
    wave_pre.launches += 1
    return out


wave_pre.launches = 0


def bind_wave_pre(lanes: Lanes, cfg):
    """K8's first launch for a loop whose live list stays on the card,
    bound once to the chunk's lanes (B of them).  Returns (``pre(live, n,
    count)``, out): out = (o [B, 3], d [B, 3], xi [B, XI_BOUNCE], the
    other draws [4, B]), the bounce's inputs, whose first rows each call
    fills; live and count device pointers (ints) of a live list (int64
    [B]) and of its count (int32), and n >= the count, which sizes the
    grid.  Each call counts in ``wave_pre.launches``."""
    L = lanes
    dev, b = L.ids.device, L.ids.shape[0]
    _check_lanes(L)
    out = _pre_out(b, dev)
    call = _build.bind("gvr_wave_pre", *_pre_tail(L, cfg, out, b),
                       device=dev)

    def pre(live: int, n: int, count: int) -> None:
        call(live, n, count)
        wave_pre.launches += 1

    return pre, out


def _post_tail(L: Lanes, xr, res, w_ne: float, env, cfg) -> tuple:
    """``gvr_wave_post``'s arguments after (live, n, count, next,
    next_count), checked: ``res`` (t_sc, scattered, albedo, li) of n_res
    slots, ``xr`` [4, stride]."""
    dev = L.ids.device
    t_sc, scattered, albedo, li = res
    n_res = t_sc.shape[0]
    for name, t in (("t_sc", t_sc), ("albedo", albedo)):
        _build.check(t, name, torch.float32, (n_res,), dev)
    if scattered.dtype not in (torch.bool, torch.float32):
        raise ValueError(f"scattered: dtype {scattered.dtype}, expected "
                         f"torch.bool or torch.float32")
    _build.check(scattered, "scattered", scattered.dtype, (n_res,), dev)
    if li.dtype != torch.float32 or li.shape != (n_res, 3) \
            or li.device != dev:
        raise ValueError(f"li: {li.dtype} {tuple(li.shape)} on "
                         f"{li.device}, expected float32 ({n_res}, 3) on "
                         f"{dev}")
    stride = xr.shape[-1]
    _build.check(xr, "xr", torch.float32, (BOUNCE_DRAWS - XI_BOUNCE, stride),
                 dev)
    _build.check(env, "env", torch.float32, (3,), dev)
    flag = scattered.dtype == torch.bool
    return (L.o, L.d, L.thr, L.acc, L.alive, L.sample, L.bounce, L.slot,
            t_sc, scattered if flag else None, None if flag else scattered,
            albedo, li, li.stride(0), li.stride(1), xr, stride, env,
            ctypes.c_float(INV_4PI), ctypes.c_float(w_ne), cfg.min_scatter,
            ctypes.c_float(cfg.rr_cap), cfg.rr_tail_after,
            ctypes.c_float(cfg.rr_cap_tail), cfg.max_bounces, cfg.spp,
            L.want)


def wave_post(lanes: Lanes, live: torch.Tensor, xr, res, w_ne: float,
              env: torch.Tensor, cfg) -> torch.Tensor:
    """After the bounce of the live lanes: ``res`` = (t_sc [n], scattered
    bool [n], albedo [n], li [n, 3], any strides) of the bounce, ``xr``
    the other draws [4, n] from ``wave_pre``, ``w_ne`` NEE's weight.
    Returns the lanes with a path to trace next (bool [B]).  A CPU tensor
    takes the plain version; a CUDA tensor launches K8's second kernel or
    raises."""
    L = lanes
    if L.ids.device.type == "cpu":
        return wave_post_reference(L, live, xr, res, w_ne, env, cfg)
    dev, b, n = L.ids.device, L.ids.shape[0], live.shape[0]
    _check_lanes(L)
    if res[0].shape[0] != n or xr.shape[-1] != n:
        raise ValueError(f"res and xr: {res[0].shape[0]} and "
                         f"{xr.shape[-1]} lanes, expected {n}")
    _build.launch("gvr_wave_post", None, b, None, None, None,
                  *_post_tail(L, xr, res, w_ne, env, cfg), device=dev)
    wave_post.launches += 1
    return L.want


wave_post.launches = 0


def bind_wave_post(lanes: Lanes, xr, res, w_ne: float, env: torch.Tensor,
                   cfg):
    """K8's second launch for a loop whose live list stays on the card,
    bound once to the chunk's lanes (B of them), the other draws ``xr``
    [4, B] and the bounce's results ``res`` (t_sc [B], scattered [B] bool,
    or float32 read as > 0.5, albedo [B], li [B, 3], any strides), each
    live lane's at its entry in the live list.  Returns ``post(live, n,
    count, nxt, nxt_count)``, device pointers (ints): it runs the lanes of
    the live list (int64 [B]) of the count (int32; n >= it sizes the
    grid) and appends each lane with a path to trace to the list nxt,
    counted in nxt_count (0 before the call).  A lane outside the list
    has no path left, and is left as it is.  Each call counts in
    ``wave_post.launches``."""
    L = lanes
    dev, b = L.ids.device, L.ids.shape[0]
    _check_lanes(L)
    if res[0].shape[0] != b or xr.shape[-1] != b:
        raise ValueError(f"res and xr: {res[0].shape[0]} and "
                         f"{xr.shape[-1]} slots, expected {b}")
    call = _build.bind("gvr_wave_post",
                       *_post_tail(L, xr, res, w_ne, env, cfg), device=dev)

    def post(live: int, n: int, count: int, nxt: int,
             nxt_count: int) -> None:
        call(live, n, count, nxt, nxt_count)
        wave_post.launches += 1

    return post
