"""V1's share of its roofline in its rows mode, %: its least time (frozen
harness/roofline.tess_rows_bound_ms over the frame's own live rows and
slerp branches, worked out by the reference's refine) over its traced
time, summed over the complete stretch frames the driver picked. A picked
frame that does not show one V1 event is left out; no such frame gives
nothing to read."""


def read(t):
    bounds = t.extras.get("v1_bound_ms") or {}
    spent, least = 0.0, 0.0
    for step, bound in bounds.items():
        times = t.step_durations_ms(step, "tess_kernel")
        if len(times) == 1:
            spent += times[0]
            least += bound
    return 100.0 * least / spent if spent > 0 else None
