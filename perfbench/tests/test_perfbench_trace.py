"""The reduction of a trace and the metric arithmetic on synthetic
events: layers by the table (@previous and a rule's next layer), the
harness's own launches left out, device events given to steps by their
launches, steps that lost events left out of the per-step numbers, host
syncs, the idle share, the rooflines, the percentile of all frames and
the rate over the window."""

import importlib.util
import os

import numpy as np
import pytest

from perfbench.drivers import common
from perfbench.harness import roofline
from perfbench.harness import trace

TABLE = {"rules": [["Memcpy HtoD", "driver", "refine"],
                   ["Memcpy DtoH", "driver", "driver"],
                   ["level_kernel", "refine"], ["cache_kernel", "cache"],
                   ["tess_kernel", "tessellate"], [".", "@previous"]],
         "require": ["level_kernel", "tess_kernel"]}
METRICS = os.path.join(os.path.dirname(os.path.dirname(__file__)),
                       "metrics")


def _x(name, cat, ts, dur, corr=None):
    e = {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur,
         "args": {}}
    if corr is not None:
        e["args"]["correlation"] = corr
    return e


def _frame(t0, corr0):
    """One 1000 us frame in its step annotation: the upload, fill, R1,
    sort, A1, V1, fetch, each with its launch on the host; a stream
    synchronize on the host; the harness's own copy after it."""
    dev = [("Memcpy HtoD (Pinned -> Device)", "gpu_memcpy", 10, 2),
           ("void at::native::fill_kernel", "kernel", 20, 3),
           ("level_kernel", "kernel", 30, 100),
           ("cub::DeviceRadixSortOnesweepKernel", "kernel", 140, 20),
           ("cache_kernel", "kernel", 170, 30),
           ("tess_kernel<true>", "kernel", 210, 40),
           ("void at::native::vectorized_elementwise_kernel", "kernel",
            260, 5),
           ("Memcpy DtoH (Device -> Pinned)", "gpu_memcpy", 300, 100)]
    out = [_x(trace.STEP, "user_annotation", t0 + 1, 998)]
    out += [_x(n, c, t0 + s, d, corr0 + i) for i, (n, c, s, d)
            in enumerate(dev)]
    out += [_x("cudaLaunchKernel", "cuda_runtime", t0 + 2 + i, 1, corr0 + i)
            for i in range(len(dev))]
    out.append(_x("cudaStreamSynchronize", "cuda_runtime", t0 + 290, 120))
    out.append(_x(trace.HARNESS, "user_annotation", t0 + 700, 50))
    out.append(_x("cudaMemcpyAsync", "cuda_runtime", t0 + 710, 5,
                  corr0 + 99))
    out.append(_x("Memcpy DtoD (Device -> Device)", "gpu_memcpy",
                  t0 + 720, 2, corr0 + 99))
    return out


def _events(frames=4):
    ev = [_x(trace.STRETCH, "user_annotation", 0, 1000 * frames)]
    for f in range(frames):
        ev += _frame(1000 * f, 1000 * f)
    # the profiler's projections of the annotations onto the device's
    # timeline, which the reduction leaves alone
    ev += [{**e, "cat": "gpu_user_annotation", "ts": e["ts"] + 3}
           for e in ev if e["cat"] == "user_annotation"]
    return ev


def _lose(ev, pred):
    """The events without those the profiler lost (pred true)."""
    return [e for e in ev if not pred(e)]


def _reader(name):
    spec = importlib.util.spec_from_file_location(
        "m", os.path.join(METRICS, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def test_layers_previous_and_next():
    red = trace.Reduced(_events(), TABLE, 4)
    layers = [d[3] for d in red.device[:8]]
    assert layers == ["driver", "refine", "refine", "refine", "cache",
                      "tessellate", "tessellate", "driver"]
    assert [d[4] for d in red.device] == [f for f in range(4)
                                          for _ in range(8)]
    assert red.complete == [0, 1, 2, 3] and red.lost_events == 0
    assert red.events_per_step() == 8           # the harness's copy left out
    assert red.layer_ms_per_step("refine") == pytest.approx(0.123)
    assert red.layer_ms_per_step("tessellate") == pytest.approx(0.045)
    assert _reader("refine_ms")(red) == pytest.approx(0.123)
    assert _reader("events_per_frame")(red) == 8
    assert _reader("host_syncs")(red) == 1
    assert _reader("cache_ms")(red) == pytest.approx(0.030)
    assert _reader("generate_ms")(red) is None  # nothing to read


def test_idle_share_is_the_union_over_the_window():
    busy = 2 + 3 + 100 + 20 + 30 + 40 + 5 + 100
    red = trace.Reduced(_events(), TABLE, 4, {"step_s": 0.0005})
    assert red.busy_s == pytest.approx(4 * busy / 1e6)
    assert red.window_s == pytest.approx(0.004)
    assert red.busy_ms_per_step() == pytest.approx(busy / 1e3)
    assert _reader("idle_share.lod")(red) == pytest.approx(
        100 * (1 - busy / 500))
    assert _reader("idle_share.lod")(trace.Reduced(_events(), TABLE, 4)) \
        is None                                 # no untraced frame time
    bd = red.breakdown()
    assert bd["device_ops"][0][0] == "level_kernel"
    assert bd["idle_gaps"][0][1] == pytest.approx(610e-6)
    assert bd["idle_gaps"][0][0] == trace.HARNESS
    assert len(bd["device_ops"]) <= 10 and len(bd["idle_gaps"]) <= 10


def test_overlapping_events_count_once():
    ev = [_x(trace.STRETCH, "user_annotation", 0, 100),
          _x(trace.STEP, "user_annotation", 0, 100),
          _x("level_kernel", "kernel", 10, 50, 1),
          _x("tess_kernel", "kernel", 30, 50, 2)]
    red = trace.Reduced(ev, TABLE, 1)
    assert red.busy_s == pytest.approx(70e-6)


def test_a_missing_kernel_refuses_the_trace():
    ev = [e for e in _events() if e["name"] != "tess_kernel<true>"]
    with pytest.raises(trace.TraceError):
        trace.Reduced(ev, TABLE, 4)


def test_a_step_count_other_than_the_stretch_refuses_the_trace():
    with pytest.raises(trace.TraceError):
        trace.Reduced(_events(), TABLE, 5)


def test_lost_launches_cost_their_step_not_the_reading():
    # the profiler lost frame 1's host calls (its sync too), and frame 2's
    # V1 on the device: both frames leave the per-step numbers, which stay
    # those of a whole frame
    ev = _lose(_events(), lambda e: (
        1000 <= e["ts"] < 2000 and e["cat"] == "cuda_runtime") or (
        e["name"] == "tess_kernel<true>" and 2000 <= e["ts"] < 3000))
    red = trace.Reduced(ev, TABLE, 4, {"step_s": 0.0005})
    assert red.complete == [0, 3]
    assert red.lost_events == 8
    assert _reader("host_syncs")(red) == 1
    assert _reader("events_per_frame")(red) == 8
    assert _reader("refine_ms")(red) == pytest.approx(0.123)
    assert red.busy_ms_per_step() == pytest.approx(0.3)


def test_more_lost_steps_than_kept_refuse_the_trace():
    ev = _lose(_events(), lambda e: e["ts"] >= 1000
               and e["cat"] == "cuda_runtime")
    with pytest.raises(trace.TraceError):
        trace.Reduced(ev, TABLE, 4)


def test_calls_the_profiler_never_records_are_no_loss():
    # a launch path whose host calls the trace never shows (all of one
    # name's events without their launch) loses nothing
    ev = _lose(_events(), lambda e: e["name"] == "cudaLaunchKernel"
               and e["args"].get("correlation", 0) % 1000 == 2)
    red = trace.Reduced(ev, TABLE, 4)
    assert red.complete == [0, 1, 2, 3] and red.lost_events == 0
    assert _reader("refine_ms")(red) == pytest.approx(0.123)


def test_unmapped_names_count_under_other():
    table = {"rules": [["level_kernel", "refine"]], "require": []}
    red = trace.Reduced(_events(1), table, 1)
    assert "cache_kernel" in red.unmapped
    assert red.has_layer("other")


def test_v1_roofline_over_the_picked_frames():
    red = trace.Reduced(_events(), TABLE, 4, {"v1_bound_ms": {0: 0.01,
                                                              2: 0.02}})
    assert _reader("v1_roofline")(red) == pytest.approx(
        100 * 0.03 / 0.08)
    # a picked frame without its V1 event is left out, not the reading
    ev = _lose(_events(), lambda e: e["name"] == "tess_kernel<true>"
               and e["ts"] < 1000)
    red = trace.Reduced(ev, {**TABLE, "require": ["level_kernel"]}, 4,
                        {"v1_bound_ms": {0: 0.01, 2: 0.02}})
    assert _reader("v1_roofline")(red) == pytest.approx(100 * 0.02 / 0.04)
    red.extras["v1_bound_ms"] = {0: 0.01}
    assert _reader("v1_roofline")(red) is None


def test_k5_roofline_and_bound():
    ev = [_x(trace.STRETCH, "user_annotation", 0, 4000)]
    for i in (0, 2):
        ev += [_x(trace.STEP, "user_annotation", 1000 * i, 2000),
               _x("cudaLaunchKernel", "cuda_runtime", 1000 * i, 5, i),
               _x("field_kernel", "kernel", 1000 * i + 10, 1500, i)]
    table = {"rules": [["field_kernel", "field"]], "require": []}
    bound = roofline.field_bound_ms(2048, 6)
    assert bound == pytest.approx(0.7801, abs=1e-4)   # PERF.md's K5 bound
    red = trace.Reduced(ev, table, 2, {"k5_bound_ms": bound,
                                       "step_s": 0.002})
    assert _reader("k5_roofline")(red) == pytest.approx(100 * bound / 1.5)
    assert _reader("idle_share.field")(red) == pytest.approx(25.0)


def test_v1_rows_bound_matches_the_tools_count():
    # tools/common.tess_rows_work at the static frame's 512 rows, 210
    # live, no slerp: 0.0100 ms by bytes (PERF.md section 6)
    assert roofline.tess_rows_bound_ms(512, 32, 0, 210) == pytest.approx(
        0.0100, abs=5e-4)


def test_percentile_of_all_frames_and_rate_over_the_window():
    times = np.concatenate([np.full(990, 1.0), np.full(10, 9.0)])
    assert np.percentile(times, 99) == pytest.approx(1.0 + 8.0 * 0.01)
    assert np.percentile(np.append(times, 9.0), 99) > 1.0
    # frame_ms is the window over the frames: a stall counts in full
    window_s, frames = 1.080, 1000
    assert window_s * 1e3 / frames == pytest.approx(1.08)


def test_sample_times_follow_the_seed():
    a = common.sample_times(5, 3)
    assert a == common.sample_times(5, 3) and a == sorted(a)
    assert a != common.sample_times(6, 3)
    assert all(0.05 <= x <= 0.95 for x in a)


def test_max_gap():
    import torch
    inf, nan = float("inf"), float("nan")
    a = torch.tensor([1.0, inf, nan, 2.0])
    assert common.max_gap(a, torch.tensor([1.0, inf, nan, 2.5])) == 0.5
    assert common.max_gap(a, torch.tensor([1.0, inf, 0.0, 2.0])) == inf
    assert common.max_gap(a, torch.tensor([1.0, inf, nan, 3.0]),
                          relative=True) == 0.25
