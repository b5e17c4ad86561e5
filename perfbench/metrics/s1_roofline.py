"""S1's share of its roofline, %: its least time (frozen
harness/roofline_splat.splat_bound_ms over the cells and covered pixels
of the reference's own splat frame at each camera) over its traced time,
summed over the complete stretch frames the driver picked. A picked frame
that does not show one S1 event (`cell_kernel`) is left out; no such
frame, or a run whose driver computes no S1 bound, gives nothing to
read."""


def read(t):
    bounds = t.extras.get("s1_bound_ms") or {}
    spent, least = 0.0, 0.0
    for step, bound in bounds.items():
        times = t.step_durations_ms(step, "cell_kernel")
        if len(times) == 1:
            spent += times[0]
            least += bound
    return 100.0 * least / spent if spent > 0 else None
