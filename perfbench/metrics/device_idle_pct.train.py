"""The share of the traced training segment in which no kernel, copy or
memset ran on the device."""


def read(r):
    if r.trace is None or not r.trace.ops:
        return None
    return 100.0 * (1.0 - r.trace.busy_s() / r.trace.window_s)
