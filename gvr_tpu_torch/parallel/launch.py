"""Run a function on the ranks of a new single-host job.

``spawn(fn, world_size, *args)`` starts ``world_size`` processes (the
``spawn`` start method: each imports ``fn`` by its module path, so ``fn``
lives in a module of this package and imports no JAX), joins them into
one process group (``sharding.init_process_group`` over
``tcp://127.0.0.1:<free port>``) and returns each rank's result of
``fn(device, *args)``, picklable values.  Every wait has a deadline: the
group's collectives time out after ``timeout`` seconds, and the parent
kills the ranks and raises once the job has run ``deadline`` seconds, or
as soon as one rank failed.  Ranks on the CPU run one thread each.
``torchrun`` is the launcher across hosts; this one serves the tests.
"""

from __future__ import annotations

import datetime
import multiprocessing as mp
import os
import pickle
import socket
import tempfile
import time
import traceback
from typing import Callable


def free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_main(fn, rank, world_size, port, device, timeout, args, out_dir):
    import torch
    import torch.distributed as dist

    from gvr_tpu_torch.parallel.sharding import init_process_group

    path = os.path.join(out_dir, f"rank{rank}.pkl")
    try:
        if torch.device(device).type == "cpu":
            torch.set_num_threads(1)
        dev = init_process_group(
            device, rank=rank, world_size=world_size,
            init_method=f"tcp://127.0.0.1:{port}",
            timeout=datetime.timedelta(seconds=timeout))
        try:
            result = {"ok": True, "value": fn(dev, *args)}
        finally:
            dist.destroy_process_group()
    except BaseException:
        result = {"ok": False, "error": traceback.format_exc()}
    with open(path + ".part", "wb") as f:
        pickle.dump(result, f)
    os.replace(path + ".part", path)
    if not result["ok"]:
        raise SystemExit(1)


def spawn(fn: Callable, world_size: int, *args, device: str = "cpu",
          timeout: float = 120.0, deadline: float | None = None) -> list:
    """[fn(device, *args) of rank 0, 1, ...] from a new job of
    ``world_size`` processes on ``device`` ('cpu' or 'cuda'; CUDA ranks
    take card ``rank % cards``).  A collective times out after
    ``timeout`` seconds, the whole job after ``deadline`` (default
    ``timeout`` plus a minute).  Raises RuntimeError with the failed
    ranks' tracebacks, or TimeoutError."""
    deadline = timeout + 60.0 if deadline is None else deadline
    ctx = mp.get_context("spawn")
    port = free_port()
    with tempfile.TemporaryDirectory() as out_dir:
        procs = [ctx.Process(target=_rank_main, args=(
            fn, r, world_size, port, device, timeout, args, out_dir))
            for r in range(world_size)]
        for p in procs:
            p.start()
        end = time.monotonic() + deadline
        try:
            while any(p.is_alive() for p in procs):
                if any(p.exitcode not in (None, 0) for p in procs):
                    break
                if time.monotonic() > end:
                    raise TimeoutError(
                        f"{fn.__name__}: {world_size} ranks still running "
                        f"after {deadline:.0f} s")
                time.sleep(0.05)
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
                p.join(timeout=30.0)
        results, errors = [], []
        for r, p in enumerate(procs):
            path = os.path.join(out_dir, f"rank{r}.pkl")
            if not os.path.exists(path):
                errors.append(f"rank {r}: exit code {p.exitcode}, no result")
                continue
            with open(path, "rb") as f:
                res = pickle.load(f)
            if res["ok"]:
                results.append(res["value"])
            else:
                errors.append(f"rank {r}:\n{res['error']}")
    if errors:
        raise RuntimeError(f"{fn.__name__} on {world_size} ranks failed:\n"
                           + "\n".join(errors))
    return results
