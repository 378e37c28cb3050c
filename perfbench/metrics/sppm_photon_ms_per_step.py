"""Milliseconds a stepwise SPPM iteration between CUDA events set around
the photon walk (``_photon_walk_all``), host issue included."""


def read(trace):
    ms = trace.phase_ms.get("photon")
    return sum(ms) / len(ms) if ms else None
