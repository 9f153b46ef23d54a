"""100 x the least time the card could take for the work the profiled
renders' paths need (``work.bound_s``: the count of a pixel sample of the
first, scaled) / the device's busy time in those renders.  It reads no
kernel's name, so it stays defined whatever kernels render the cell."""


def read(run):
    t = run["trace"]
    if not t or t["busy_s"] <= 0:
        return None
    return 100.0 * t["bound_s"] / t["busy_s"]
