"""K5's share of its roofline, %: its least time for the six faces
(frozen harness/roofline.field_bound_ms: each texel's operations and
bytes) over its traced time, over the complete regens of the stretch."""


def read(t):
    times = t.durations_ms("field_kernel")
    bound = t.extras.get("k5_bound_ms")
    if not times or bound is None or sum(times) <= 0:
        return None
    return 100.0 * bound * len(times) / sum(times)
