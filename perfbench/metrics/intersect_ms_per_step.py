"""Device milliseconds a step of the intersection kernels: the sweep, its
prologue, the BVH walk and the brute-force test, by their CUDA names."""
import re

KERNELS = re.compile(r"\b(sweep_kernel|sweep_tiled_kernel|entry_kernel|"
                     r"prologue_kernel|bvh_walk_kernel|intersect_kernel)\b")


def read(trace):
    hits = [e for e in trace.in_steps(trace.kernels()) if KERNELS.search(e[0])]
    if not hits or not trace.n_steps:
        return None
    return sum(b - a for _, a, b in hits) * 1e-3 / trace.n_steps
