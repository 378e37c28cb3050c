"""CUDA kernels the profiler sees a step, the kernels of replayed CUDA
graphs included: the host-issue load of the integrator's passes."""


def read(trace):
    if not trace.n_steps:
        return None
    n = len(trace.in_steps(trace.kernels()))
    return n / trace.n_steps if n else None
