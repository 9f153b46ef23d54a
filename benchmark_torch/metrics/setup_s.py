"""Seconds from the process's start to the window's: imports, the CUDA
context, the kernels' build or load, the scene made and parsed, and the
warm-up render (with the grid build where the cell takes the grid)."""


def read(run):
    return run["setup_s"]
