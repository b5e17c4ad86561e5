"""Host-side calls that wait for the device (stream, device and event
synchronizes, synchronous copies) a frame, from the profiler's CPU
activity over the traced stretch."""


def read(t):
    return t.syncs_per_step() if t.steps else None
