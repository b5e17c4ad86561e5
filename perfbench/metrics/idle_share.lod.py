"""The device's idle share of an untraced frame, %: 1 - the device-busy
time a frame (the union of its kernels, copies and fills, over the
traced stretch's complete frames) over the frame's time on the host clock
in the same run's untraced window (the window's seconds over its frames,
as frame_ms). The profiler's own host work lengthens a traced frame, so
the traced stretch's wall time would count it as idle."""


def read(t):
    step_s = t.extras.get("step_s")
    return t.idle_share(step_s) if t.device and step_s else None
