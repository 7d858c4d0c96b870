"""The incidence kernel's share of its roofline: the least time of the
live work of its calls (roofline.py) over the profiler's device time
under the kernel's symbols (pre-pass and tensor-core product)."""

from benchmark.metrics.roofline import share


def read(run):
    return share(run, "incidence_matmul")
