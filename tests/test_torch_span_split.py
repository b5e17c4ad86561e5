"""planet_tpu_torch/tools/span_split on hand-made traces of the port's
planet/ spans and on the driver's own --profile trace (the CPU): nested
spans count once, an idle gap across spans is split between them, a gap
outside every span counts there, spans that start outside the window are
left out, a device clock that drifts from the host's is put back on it by
the direct launches' least lag, and a trace without the spans gives no
times."""

import io
import json
import os
import sys

import pytest

from planet_tpu_torch.io import driver
from planet_tpu_torch.tools import span_split

LOD = ("enqueue_host_ms", "readback_host_ms", "idle_enqueue_ms",
       "idle_readback_ms", "idle_render_own_ms", "idle_outside_render_ms")
STRETCH = "bench/stretch"


def _x(name, cat, ts, dur, corr=None):
    e = {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur,
         "args": {}}
    if corr is not None:
        e["args"]["correlation"] = corr
    return e


def _lod_frame(o, corr, capture=False):
    """A 1000-us frame from o: planet/render [10, 900] holding camera
    [20, 60], geometry [60, 400] (upload [70, 100], replay [300, 350]),
    raster [400, 500] (replay [450, 480]) and readback [600, 880]; the
    geometry replay's kernel on the device [320, 620] and the preview's
    copy [700, 850], launched at its start in the readback."""
    out = [_x("planet/" + n, "cpu_op", o + a, b - a) for n, a, b in (
        ("render", 10, 900), ("camera", 20, 60), ("geometry", 60, 400),
        ("upload", 70, 100), ("replay", 300, 350), ("raster", 400, 500),
        ("replay", 450, 480), ("readback", 600, 880))]
    out += [_x("cudaGraphLaunch", "cuda_runtime", o + 310, 5, corr),
            _x("step_kernel", "kernel", o + 320, 300, corr),
            _x("cudaMemcpyAsync", "cuda_runtime", o + 700, 150, corr + 1),
            _x("Memcpy DtoH (Device -> Pageable)", "gpu_memcpy", o + 700,
               150, corr + 1)]
    if capture:
        out.append(_x("planet/capture", "cpu_op", o + 110, 90))
    return out


def _lod(capture_in=None, drift=0.0):
    """Two frames in a 2000-us window after a lead-in frame (with a
    capture); the device's events `drift` us a us ahead of the host."""
    ev = [_x(STRETCH, "user_annotation", 0, 2000)]
    for k in (-1, 0, 1):
        ev += _lod_frame(1000 * k, 10 * (k + 1),
                         capture=k == capture_in or k < 0)
    for e in ev:
        if e["cat"] in ("kernel", "gpu_memcpy"):
            e["ts"] -= drift * e["ts"]
    return ev


def test_lod_frames_split_their_idle_time_by_innermost_span():
    """Idle gaps [0, 320], [620, 700], [850, 1320], [1620, 1700],
    [1850, 2000] over two frames (the lead-in's copy ends at -150)."""
    got = span_split.split(_lod(), STRETCH)
    assert got["steps"] == 2 and got["idle_ms"] == pytest.approx(0.55)
    # camera 40 + geometry 10 + upload 30 + geometry 200 + replay 20, twice
    assert got["idle_enqueue_ms"] == pytest.approx(0.300)
    # [620, 700] and [850, 880], twice
    assert got["idle_readback_ms"] == pytest.approx(0.110)
    # render's own [10, 20] and [880, 900], twice
    assert got["idle_render_own_ms"] == pytest.approx(0.030)
    # [0, 10], [900, 1010], [1900, 2000]: the caller's loop
    assert got["idle_outside_render_ms"] == pytest.approx(0.110)
    assert sum(got[n] for n in LOD[2:]) == pytest.approx(got["idle_ms"])
    # nested spans counted once: camera 40 + geometry 340 + raster 100
    assert got["enqueue_host_ms"] == pytest.approx(0.480)
    assert got["host_ms"]["planet/geometry"] == pytest.approx(0.260)
    assert got["readback_host_ms"] == pytest.approx(0.280)
    assert got["recaptures"] == 0        # the lead-in's capture left out
    assert got["clock"] == {"lead_us_at_start": 0.0, "lead_us_at_end": 0.0}
    assert got["lag_us"]["cudaGraphLaunch"]["least"] == 10.0
    assert "idle_field_ms" not in got


def test_a_capture_counts_and_stays_enqueue_time():
    got = span_split.split(_lod(capture_in=1), STRETCH)
    assert got["recaptures"] == 1
    assert got["enqueue_host_ms"] == pytest.approx(0.480)
    assert got["idle_enqueue_ms"] == pytest.approx(0.300)


@pytest.mark.parametrize("drift", [1e-3, -1e-3])
def test_a_drifting_device_clock_is_put_back_on_the_host_clock(drift):
    """The device's events 0.1 % ahead of the host (behind it), more as
    the window goes on: the raw lags drift, the split is the undrifted
    one."""
    got = span_split.split(_lod(drift=drift), STRETCH)
    lags = got["lag_us"]["cudaMemcpyAsync"]
    assert lags["least"] == pytest.approx(-1.7 if drift > 0 else 0.7)
    assert got["clock"]["lead_us_at_start"] == pytest.approx(0.0, abs=0.1)
    assert got["clock"]["lead_us_at_end"] == pytest.approx(
        -2000 * drift, abs=0.1)
    want = span_split.split(_lod(), STRETCH)
    for name in LOD + ("idle_ms",):
        assert got[name] == pytest.approx(want[name], abs=5e-4), name


def test_the_clock_move_takes_out_a_drift_and_a_negative_lead():
    fit = (30.0, 0.01)                       # 30 us, rising to 40
    move = span_split.shift(fit, 0.0, 1000.0)
    assert [move(t) for t in (0.0, 500.0, 1000.0)] == [0.0, 5.0, 10.0]
    move = span_split.shift((-50.0, 0.05), 0.0, 1000.0)   # -50 to 0
    assert [move(t) for t in (0.0, 1000.0)] == [-50.0, 0.0]
    assert span_split.shift(None, 0.0, 1000.0)(500.0) == 0.0


def test_a_gap_across_spans_is_split_between_them():
    """One idle gap from the middle of a readback through the caller's
    loop into the next frame's camera; the window from the first render
    to the last."""
    ev = [_x("cudaLaunchKernel", "cuda_runtime", 5, 1, 1),
          _x("k", "kernel", 5, 295, 1),
          _x("planet/render", "cpu_op", 5, 395),
          _x("planet/readback", "cpu_op", 250, 100),
          _x("planet/render", "cpu_op", 500, 400),
          _x("planet/camera", "cpu_op", 520, 80),
          _x("cudaLaunchKernel", "cuda_runtime", 600, 1, 2),
          _x("k", "kernel", 600, 400, 2)]
    got = span_split.split(ev)
    assert got["window_ms"] == pytest.approx(0.895 / 2)
    # gap [300, 600]: readback 50, render 50, outside 100, render 20,
    # camera 80 (per step: halved)
    assert got["idle_readback_ms"] == pytest.approx(0.025)
    assert got["idle_outside_render_ms"] == pytest.approx(0.050)
    assert got["idle_render_own_ms"] == pytest.approx(0.035)
    assert got["idle_enqueue_ms"] == pytest.approx(0.040)
    assert got["readback_host_ms"] == pytest.approx(0.050)


def test_field_regens_split_idle_time_inside_and_outside_the_field():
    ev = [_x(STRETCH, "user_annotation", 0, 2000)]
    for k in range(2):
        o = 1000 * k
        ev += [_x("planet/field", "cpu_op", o + 10, 90),
               _x("cudaLaunchKernel", "cuda_runtime", o + 90, 5, k),
               _x("field_kernel", "kernel", o + 120, 780, k),
               _x("cudaDeviceSynchronize", "cuda_runtime", o + 100, 805)]
    got = span_split.split(ev, STRETCH)
    assert got["steps"] == 2 and not any(n in got for n in LOD)
    # a steady 30-us launch lag: nothing moves
    assert got["clock"] == {"lead_us_at_start": 30.0, "lead_us_at_end": 30.0}
    assert got["idle_field_ms"] == pytest.approx(0.090)   # [10, 100] twice
    # [0, 10], [100, 120], [900, 1010], [1100, 1120], [1900, 2000]
    assert got["idle_outside_field_ms"] == pytest.approx(0.130)


def test_no_planet_span_gives_no_times():
    ev = [e for e in _lod() if not e["name"].startswith("planet/")]
    assert span_split.split(ev, STRETCH) == {"steps": 0}
    assert span_split.split(ev) == {"steps": 0}
    assert span_split.split(ev, "no/such") == {"steps": 0}


def test_the_drivers_profile_on_the_cpu(tmp_path, monkeypatch, capsys):
    """main --interactive --device --profile on the CPU backend: the tool
    reads its trace.json, a step a frame; the device idles all along, so
    the enqueue spans' host time is all idle, and the idle parts make up
    the window."""
    prof = str(tmp_path / "prof")
    monkeypatch.setattr(sys, "stdin", io.StringIO("w\nright\nd\nq\n"))
    driver.main(["--interactive", "--device", "--width", "64", "--height",
                 "48", "--altitude", "2e7", "--out", str(tmp_path / "out"),
                 "--no-save", "--profile", prof, "--backend", "cpu"])
    capsys.readouterr()
    path = os.path.join(prof, "trace.json")
    span_split.main([path])
    got = json.loads(capsys.readouterr().out)
    assert got["steps"] == 3 and got["recaptures"] == 0
    assert got["clock"] is None and got["lag_us"] == {}
    assert got["enqueue_host_ms"] > 0 and got["readback_host_ms"] > 0
    assert got["idle_enqueue_ms"] == pytest.approx(got["enqueue_host_ms"])
    assert got["idle_ms"] == pytest.approx(got["window_ms"])
    assert sum(got[n] for n in LOD[2:]) == pytest.approx(got["idle_ms"])
    assert set(got["host_ms"]) == {
        "outside", "planet/render", "planet/camera", "planet/geometry",
        "planet/upload", "planet/raster", "planet/readback"}
