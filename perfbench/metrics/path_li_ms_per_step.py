"""Milliseconds a path-traced frame between CUDA events set around each
``PathIntegrator.li`` call (a sample pass's paths, 4 a frame of
cornell_mis_512), host issue included: the calls' sum over the traced
frames, over the frames."""


def read(trace):
    ms = trace.phase_ms.get("li")
    return sum(ms) / trace.n_steps if ms and trace.n_steps else None
