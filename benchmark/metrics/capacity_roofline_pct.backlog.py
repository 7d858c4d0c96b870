"""The capacity kernel's share of its roofline: the least time of the
live work of its calls (roofline.py) over the profiler's device time
under the kernel's symbols."""

from benchmark.metrics.roofline import share


def read(run):
    return share(run, "capacity_fit")
