"""The port's driver (planet_tpu_torch.io.driver) and timing utilities on the
CPU: the cases of tests/test_driver.py (interactive moves, camera slots,
speed digits, toggles, unknown keys, --save-slot, `main --frames 1`) on a
64x48 engine whose probe heights are zeros (planet_tpu marks its copy
`slow` for its XLA compiles; the port's needs none), the fused device path
behind --interactive --device (DeviceInteractiveEngine, preview 2: a `png`
dump holds the full frame), --profile and --check-finite,
utils/timing and its spans (one shared no-op with no profiler running;
under one, planet/ ranges nested as the fused frame and frame_cube make
them), and the camera checkpoint across the two packages' drivers
(planet_tpu's driver saves, the port's loads, and the other way round)."""

import io
import json
import os
import sys
import zlib

import numpy as np
import pytest
import torch

from planet_tpu.io import checkpoint as j_checkpoint
from planet_tpu.io import driver as j_driver
from planet_tpu_torch.engine.config import EngineConfig
from planet_tpu_torch.engine.planet import PlanetEngine
from planet_tpu_torch.geom import camera as cam_mod
from planet_tpu_torch.io import checkpoint, driver
from planet_tpu_torch.utils import timing

torch.set_num_threads(1)
W, H = 64, 48
RADIUS = 6371000.0


def _zeros(p):
    return np.zeros(len(p), np.float32)


@pytest.fixture(scope="module")
def engine():
    cfg = EngineConfig(window_w=W, window_h=H, raster_supersample=1)
    # smooth sphere probes: cheap frames, geometry still exercised end to end
    return PlanetEngine(cfg, device="cpu", height_fn=_zeros)


def _cam(alt=100e3):
    return cam_mod.Camera(position=np.array([0.0, 0.0, -(RADIUS + alt)]))


def _png_pixels(path):
    data = open(path, "rb").read()
    width, height = (int.from_bytes(data[16 + 4 * i:20 + 4 * i], "big")
                     for i in range(2))
    idat = data[data.index(b"IDAT") + 4:data.index(b"IEND") - 8]
    raw = np.frombuffer(zlib.decompress(idat), np.uint8)
    return raw.reshape(height, -1)[:, 1:].reshape(height, width)


# ------------------------------------------- tests/test_driver.py's cases


def test_interactive_moves_and_slots(engine, tmp_path, capsys):
    _, slots = checkpoint.default_state()
    cam = _cam()
    p0 = cam.position.copy()
    out = driver.run_interactive(engine, cam, slots, W, H, str(tmp_path),
                                 stream=io.StringIO("w 4\nsf3 w\nf3\nq\n"))
    text = capsys.readouterr().out
    assert text.count("frametime:") == 3          # one frame a line
    # line 1 moves at the default speed, then sets 10^4 m/s; line 2 saves
    # slot 3 before its move (key order within a line); line 3 recalls it
    assert np.linalg.norm(np.asarray(slots[2].position) - p0) > 0
    np.testing.assert_array_equal(out.position, slots[2].position)


def test_interactive_look_and_toggles(engine, tmp_path, capsys):
    _, slots = checkpoint.default_state()
    cam = _cam()
    a0 = cam.angles.copy()
    wf0, sk0 = engine.wireframe, engine.skirts
    driver.run_interactive(engine, cam, slots, W, H, str(tmp_path),
                           stream=io.StringIO("up left\np\np\nk\nq\n"))
    capsys.readouterr()
    assert cam.angles[0] < a0[0] and cam.angles[1] < a0[1]
    assert engine.wireframe == wf0                 # toggled twice
    assert engine.skirts != sk0
    driver.run_interactive(engine, cam, slots, W, H, str(tmp_path),
                           stream=io.StringIO("p k\nq\n"))
    capsys.readouterr()
    assert engine.wireframe != wf0 and engine.skirts == sk0
    engine.wireframe = wf0


def test_interactive_speed_digits(engine, tmp_path, capsys):
    _, slots = checkpoint.default_state()
    p0 = _cam().position.copy()
    cam = _cam()
    driver.run_interactive(engine, cam, slots, W, H, str(tmp_path),
                           stream=io.StringIO("1 w\nq\n"))
    cam2 = _cam()
    driver.run_interactive(engine, cam2, slots, W, H, str(tmp_path),
                           stream=io.StringIO("5 w\nq\n"))
    capsys.readouterr()
    d_slow = np.linalg.norm(cam.position - p0)
    d_fast = np.linalg.norm(cam2.position - p0)
    np.testing.assert_allclose(d_fast / d_slow, 1e4, rtol=1e-6)


def test_interactive_unknown_keys_help_and_png(engine, tmp_path, capsys):
    _, slots = checkpoint.default_state()
    cam = _cam()
    driver.run_interactive(engine, cam, slots, W, H, str(tmp_path),
                           stream=io.StringIO("xyz help\nt t png\nq w\n"))
    text = capsys.readouterr().out
    assert "? unknown key 'xyz'" in text
    assert driver.INTERACTIVE_HELP in text
    assert text.count("frametime:") == 2          # "q" ends before a frame
    assert os.listdir(tmp_path) == ["interactive_0001.png"]
    _, image, _ = engine.render(cam, W, H)
    want = (np.clip(image.numpy(), 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)
    np.testing.assert_array_equal(
        _png_pixels(tmp_path / "interactive_0001.png"), want)


def test_driver_save_slot_flag(tmp_path, capsys):
    """--save-slot stores the session camera into the checkpoint (the
    shift+F analogue, main.cpp:958-975 + 1118-1138)."""
    save = str(tmp_path / "save.npz")
    driver.main(["--frames", "1", "--width", "48", "--height", "36",
                 "--out", str(tmp_path / "frames"), "--save", save,
                 "--altitude", "250000", "--save-slot", "7",
                 "--backend", "cpu"])
    assert "frametime:" in capsys.readouterr().out
    assert os.path.exists(tmp_path / "frames" / "frame_0000.png")
    active, slots = checkpoint.load(save)
    np.testing.assert_array_equal(slots[7].position, active.position)
    np.testing.assert_allclose(np.linalg.norm(active.position),
                               RADIUS + 250000.0)


# ------------------------------------------------- --interactive --device


def test_device_interactive_png_dump_is_the_full_frame(tmp_path, capsys):
    cfg = EngineConfig(window_w=W, window_h=H)
    kw = dict(cap=1024, render_cap=256, gen_cap=128)
    ieng = driver.DeviceInteractiveEngine(cfg, W, H, preview=2,
                                          device="cpu", **kw)
    _, slots = checkpoint.default_state()
    cam = driver.run_interactive(ieng, _cam(), slots, W, H, str(tmp_path),
                                 stream=io.StringIO("w\nk\npng\nq\n"))
    text = capsys.readouterr().out
    assert text.count("frametime:") == 3
    assert "skirt toggle is baked" in text and ieng.skirts
    frame = ieng.renderer.render(ieng.pool, *_device_args(cfg, cam))
    assert frame.n_generated == 0
    assert frame.image.dtype == torch.uint8 and frame.image.shape == (H, W)
    assert frame.preview.shape == (H // 2, W // 2)
    assert torch.equal(frame.preview, frame.image[::2, ::2])
    np.testing.assert_array_equal(
        _png_pixels(tmp_path / "interactive_0002.png"), frame.image.numpy())
    ieng.wireframe = True                 # a raster option of the renderer
    assert ieng.renderer.wireframe and ieng.wireframe
    _, wire, _ = ieng.render(cam)
    assert wire.shape == (H, W) and int(wire.sum()) > 0


def _device_args(cfg, cam):
    from planet_tpu_torch.nums import df as tdf
    rot = cam_mod.camera_rotation(cam)
    pf = cam_mod.proj_factor_from_fovy(np.deg2rad(cfg.fovy_deg))
    vp = (cam_mod.perspective_lh(pf, W / H, cfg.near_plane, cfg.far_plane)
          @ cam_mod.view_from_rotation(rot)).astype(np.float32)
    return (*tdf.from_f64_np(cam.position), vp)


def test_main_interactive_device_profile(tmp_path, monkeypatch, capsys):
    """main --interactive --device on a scripted stdin, with --profile (a
    CPU-activity trace on the cpu backend) and --save-slot; --device
    without --interactive renders PlanetEngine frames, as planet_tpu's
    driver does."""
    save, prof = str(tmp_path / "save.npz"), str(tmp_path / "prof")
    monkeypatch.setattr(sys, "stdin", io.StringIO("w\nright\nq\n"))
    driver.main(["--interactive", "--device", "--preview", "2", "--width",
                 str(W), "--height", str(H), "--altitude", "2e7", "--out",
                 str(tmp_path / "out"), "--save", save, "--save-slot", "4",
                 "--profile", prof, "--backend", "cpu"])
    text = capsys.readouterr().out
    assert driver.INTERACTIVE_HELP in text and text.count("frametime:") == 2
    trace = json.load(open(os.path.join(prof, "trace.json")))
    assert len(trace["traceEvents"]) > 0
    active, slots = checkpoint.load(save)
    np.testing.assert_array_equal(slots[4].position, active.position)
    assert active.angles[1] > 0
    driver.main(["--device", "--frames", "1", "--width", "32", "--height",
                 "24", "--altitude", "2e7", "--out", str(tmp_path / "f"),
                 "--no-save", "--backend", "cpu"])
    assert os.listdir(tmp_path / "f") == ["frame_0000.png"]


def test_check_finite_counts_nonfinite_tiles(caplog):
    cam = _cam(2e7)
    ok = PlanetEngine(EngineConfig(window_w=32, window_h=24,
                                   check_finite=True), device="cpu")
    ok.render(cam)
    assert ok.nonfinite_tiles == 0
    bad = PlanetEngine(EngineConfig(window_w=32, window_h=24,
                                    amplitude=float("inf"),
                                    check_finite=True), device="cpu")
    out = bad.frame(cam)
    assert bad.nonfinite_tiles == out.stats.tiles_generated > 0
    assert "non-finite tiles" in caplog.text
    off = PlanetEngine(EngineConfig(window_w=32, window_h=24,
                                    amplitude=float("inf")), device="cpu")
    off.frame(cam)
    assert off.nonfinite_tiles == 0


# ------------------------------------------------------------ utils/timing


def test_timing_toggle_timed_bench_report(capsys):
    """The key-T toggle, `timed`'s print while it is on (and silence while
    it is off), and `synchronize` on CPU tensors and devices."""
    was = timing.timing_enabled()
    assert timing.toggle_timing() != was
    assert timing.timing_enabled() != was
    x = torch.arange(10.0)
    with timing.timed("port-test-block", sync=x):
        x = x * 2
    with timing.timed("port-test-block", sync=torch.device("cpu")):
        pass
    printed = capsys.readouterr().out.count("[timing] port-test-block")
    assert printed == (2 if timing.timing_enabled() else 0)
    if timing.toggle_timing() != was:
        timing.toggle_timing()
    assert timing.timing_enabled() == was
    timing.synchronize([x, "cpu", torch.device("cpu")])
    assert torch.equal(x, torch.arange(10.0) * 2)


def _planet_spans(tmp_path, fn):
    """fn() under a CPU torch.profiler trace: the trace's planet/ spans as
    [name, start us, end us], by start, and fn's result."""
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        out = fn()
    path = str(tmp_path / "trace.json")
    prof.export_chrome_trace(path)
    spans = [[e["name"], float(e["ts"]), float(e["ts"]) + float(e["dur"])]
             for e in json.load(open(path))["traceEvents"]
             if e.get("ph") == "X"
             and str(e.get("name", "")).startswith(timing.SPAN_PREFIX)]
    return sorted(spans, key=lambda s: s[1]), out


def _inside(inner, outer):
    return outer[1] <= inner[1] and inner[2] <= outer[2]


def test_span_off_is_one_shared_noop():
    a, b = timing.span("render"), timing.span("field")
    assert a is b
    with a:
        pass


@pytest.mark.parametrize("fast", [True, False])
def test_span_records_a_planet_range(tmp_path, monkeypatch, fast):
    """Under a profiler a span records planet/<name> around its block (by
    _RecordFunctionFast, or record_function where torch lacks it), nested
    spans inside it; after the profiler, the no-op again."""
    if not fast:
        monkeypatch.setattr(timing, "_FAST_SPAN", None)

    def run():
        with timing.span("outer"):
            with timing.span("inner"):
                torch.ones(4).sum()

    spans, _ = _planet_spans(tmp_path, run)
    assert [s[0] for s in spans] == ["planet/outer", "planet/inner"]
    assert _inside(spans[1], spans[0])
    assert timing.span("outer") is timing.span("inner")


def test_device_interactive_frame_spans(tmp_path):
    """Two frames of the fused path on the CPU under a profiler: once a
    frame planet/render, holding planet/camera, planet/geometry (holding
    planet/upload), planet/raster and planet/readback, in that order; no
    planet/capture, since the CPU runs the step eagerly."""
    cfg = EngineConfig(window_w=W, window_h=H)
    ieng = driver.DeviceInteractiveEngine(cfg, W, H, preview=2,
                                          device="cpu", cap=1024,
                                          render_cap=256, gen_cap=128)
    cam = _cam(2e7)
    spans, _ = _planet_spans(
        tmp_path, lambda: [ieng.render(cam) for _ in range(2)])
    renders = [s for s in spans if s[0] == "planet/render"]
    assert len(renders) == 2 and renders[0][2] <= renders[1][1]
    for r in renders:
        inner = [s for s in spans if s is not r and _inside(s, r)]
        assert [s[0] for s in inner] == [
            "planet/camera", "planet/geometry", "planet/upload",
            "planet/raster", "planet/readback"]
        camera, geometry, upload, raster, readback = inner
        assert _inside(upload, geometry)
        assert (camera[2] <= geometry[1] and geometry[2] <= raster[1]
                and raster[2] <= readback[1])
    assert len(spans) == 12


@pytest.mark.parametrize("n,fused", [(16, False), (128, True)])
def test_frame_cube_span(tmp_path, n, fused):
    """One planet/field around a whole frame_cube call, fused (K5's plain
    version on the CPU) or composed."""
    from planet_tpu_torch.models import heightfield
    spans, (h, _) = _planet_spans(tmp_path, lambda: heightfield.frame_cube(
        n, RADIUS, fused=fused, device="cpu"))
    assert [s[0] for s in spans] == ["planet/field"]
    assert h.shape == (6, n, n)


# ------------------------------------------- the checkpoint across drivers


def test_checkpoint_round_trip_across_drivers(tmp_path, capsys):
    """planet_tpu's driver saves, the port's driver loads (slot recall) and
    saves, planet_tpu's driver loads that; no frame is rendered (--frames
    0), so nothing is compiled."""
    save = str(tmp_path / "save.npz")
    out = str(tmp_path / "out")
    j_driver.main(["--frames", "0", "--save", save, "--out", out,
                   "--altitude", "123456", "--save-slot", "5",
                   "--no-pallas"])
    ja, js = j_checkpoint.load(save)
    driver.main(["--frames", "0", "--save", save, "--out", out, "--slot",
                 "5", "--altitude", "654321", "--save-slot", "2",
                 "--backend", "cpu"])
    ta, ts = checkpoint.load(save)
    np.testing.assert_array_equal(ts[5].position, js[5].position)
    np.testing.assert_allclose(np.linalg.norm(ta.position), RADIUS + 654321.0)
    np.testing.assert_array_equal(ts[2].position, ta.position)
    j_driver.main(["--frames", "0", "--save", save, "--out", out, "--slot",
                   "2", "--save-slot", "9", "--no-pallas"])
    ja2, js2 = j_checkpoint.load(save)
    np.testing.assert_array_equal(ja2.position, ta.position)
    np.testing.assert_array_equal(ja2.angles, ta.angles)
    np.testing.assert_array_equal(js2[9].position, ta.position)
    np.testing.assert_array_equal(js2[5].position, js[5].position)
    capsys.readouterr()
