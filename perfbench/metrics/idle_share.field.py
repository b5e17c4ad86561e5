"""The device's idle share of an untraced regen, %: 1 - the device-busy
time a regen (the union of its kernels, copies and fills, over the
traced stretch's complete regens) over the regen's time on the host clock
in the same run's untraced window (the window's seconds over its regens,
as regen_ms). The profiler's own host work lengthens a traced regen, so
the traced stretch's wall time would count it as idle."""


def read(t):
    step_s = t.extras.get("step_s")
    return t.idle_share(step_s) if t.device and step_s else None
