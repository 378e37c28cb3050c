"""Milliseconds a stepwise SPPM iteration between CUDA events set around
the camera pass (``_camera_pass_all``), host issue included."""


def read(trace):
    ms = trace.phase_ms.get("camera")
    return sum(ms) / len(ms) if ms else None
