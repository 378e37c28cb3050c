"""Share of the profiled whole steps in which nothing ran on the card."""


def read(trace):
    window = trace.window_us()
    if window <= 0 or not trace.device:
        return None
    return 100.0 * (1.0 - trace.busy_us() / window)
