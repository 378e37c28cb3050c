"""Milliseconds a path-traced frame between CUDA events set around each
``wavefront/path.py::estimate_direct`` call (a bounce's light-sampling
and BSDF-sampling MIS legs, 20 a frame of cornell_mis_512), host issue
included: the calls' sum over the traced frames, over the frames."""


def read(trace):
    ms = trace.phase_ms.get("direct")
    return sum(ms) / trace.n_steps if ms and trace.n_steps else None
