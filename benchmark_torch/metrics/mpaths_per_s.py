"""Millions of paths (width x height x spp) of the renders completed in
the window, over the wall time from the window's start to the end of its
last render (host clock)."""


def read(run):
    w = run["window"]
    return w["paths"] / w["seconds"] / 1e6 if w["renders"] else None
