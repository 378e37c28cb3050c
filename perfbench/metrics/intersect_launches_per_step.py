"""Launches a step of the intersection kernels (names as in
intersect_ms_per_step)."""
from perfbench.metrics.intersect_ms_per_step import KERNELS


def read(trace):
    n = sum(1 for e in trace.in_steps(trace.kernels()) if KERNELS.search(e[0]))
    if not n or not trace.n_steps:
        return None
    return n / trace.n_steps
