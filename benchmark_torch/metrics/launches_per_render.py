"""Kernel-launch calls (cudaLaunchKernel and its kin, the port's and
PyTorch's) in the profiled renders, per render (torch.profiler)."""


def read(run):
    t = run["trace"]
    return t["launches"] / t["renders"] if t and t["renders"] else None
