"""100 x (1 - the union of the device's activity intervals / the wall
time) over the profiled renders (torch.profiler)."""


def read(run):
    t = run["trace"]
    if not t or t["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
