"""planet_tpu_torch imports neither jax nor planet_tpu: in a fresh
interpreter, import every module of the package (the attribution tools
under planet_tpu_torch/tools included), render one tiny LOD frame in each
raster mode and one small cube-sphere field frame on the CPU, run the
terrain and heightmap API, the driver's non-interactive and interactive
loops, the entry forward step, the three tools at their small sizes and
the sharded field and LOD paths on a gloo world of one rank, one
truncated rung of the device step and dryrun_multichip on one spawned
CPU rank, then check sys.modules. And no source file of the port, nor
chip_smoke.py, nor the tests' helpers that the port's ranks and its card
tests import, names a jax or planet_tpu module in an import."""

import ast
import pathlib
import subprocess
import sys
import textwrap

ROOT = pathlib.Path(__file__).resolve().parent.parent

SCRIPT = textwrap.dedent("""
    import importlib, pkgutil, sys, tempfile, os
    import numpy as np
    import torch
    torch.set_num_threads(1)
    import planet_tpu_torch
    names = [m.name for m in pkgutil.walk_packages(
        planet_tpu_torch.__path__, "planet_tpu_torch.")]
    for name in names:
        importlib.import_module(name)
    tools = {"planet_tpu_torch.tools." + m
             for m in ("common", "noise_stages", "lut", "span_parts")}
    assert tools <= set(names), sorted(tools - set(names))
    rest = {"planet_tpu_torch." + m
            for m in ("raster.splat", "models.terrain", "ops.heightmap",
                      "utils.timing", "io.driver", "entry",
                      "parallel.sharded", "parallel.sharded_lod",
                      "parallel.ranks", "tools.stage_times")}
    assert rest <= set(names), sorted(rest - set(names))
    from planet_tpu_torch.engine.config import EngineConfig
    from planet_tpu_torch.engine.planet import PlanetEngine
    from planet_tpu_torch.geom import camera as cam_mod
    from planet_tpu_torch.io import driver
    from planet_tpu_torch.models import heightfield
    eng = PlanetEngine(EngineConfig(window_w=64, window_h=48), device="cpu")
    cam = cam_mod.Camera(position=np.array([0.0, 0.0, -1.9113e7]),
                         angles=np.array([np.pi / 2, 0.0, 0.0], np.float32))
    out, image, depth = eng.render(cam)
    assert np.isfinite(depth.numpy()).mean() > 0.2
    h, s = heightfield.frame_cube(128, 6.371e6, device="cpu")
    assert h.shape == s.shape == (6, 128, 128)
    assert bool(torch.isfinite(h).all()) and bool(torch.isfinite(s).all())
    with tempfile.TemporaryDirectory() as d:
        driver.main(["--frames", "1", "--width", "32", "--height", "24",
                     "--altitude", "2e7", "--backend", "cpu", "--no-save",
                     "--out", d])
        assert os.path.exists(os.path.join(d, "frame_0000.png"))
    import io
    from planet_tpu_torch import entry
    from planet_tpu_torch.models import terrain
    from planet_tpu_torch.nums import df as tdf
    from planet_tpu_torch.ops import heightmap, perlin
    from planet_tpu_torch.utils import timing
    seng = PlanetEngine(EngineConfig(window_w=64, window_h=48,
                                     raster_mode="splat",
                                     raster_supersample=2), device="cpu")
    with timing.timed("nojax-splat", sync=torch.device("cpu")):
        _, simage, sdepth = seng.render(cam)
    assert np.isfinite(sdepth.numpy()).mean() > 0.2
    pts = np.load("tests/goldens/pts_sphere.npy")[:64]
    ridged = terrain.RidgedTerrain()
    h64 = ridged.height_f64(pts, 6, 18, device="cpu")
    p3 = [tuple(torch.as_tensor(a) for a in tdf.from_f64_np(pts[:, k]))
          for k in range(3)]
    assert float((ridged.height_df(*p3, 6, 18) - h64).abs().max()) < 0.2
    ch, cl = (torch.as_tensor(a) for a in tdf.from_f64_np(
        np.load("tests/goldens/tile_corners.npy")[:2]))
    tiles = heightmap.generate_tiles_df(ch, cl, 32, ridged, 3, 18)
    assert tiles.shape == (2, 32, 32)
    assert perlin.perlin3_f64(pts[:, 0], pts[:, 1], pts[:, 2],
                              device="cpu").shape == (64,)
    with tempfile.TemporaryDirectory() as d:
        driver.run_interactive(seng, cam.copy(), [cam.copy()] * 12, 64, 48,
                               d, stream=io.StringIO("w p\\npng\\nq\\n"))
        assert os.listdir(d) == ["interactive_0001.png"]
    forward, args = entry.entry(device="cpu")
    clip, shade = forward(*[a if i == 7 else a[:2]
                            for i, a in enumerate(args)])
    assert bool(torch.isfinite(clip).all()) and shade.shape == (2, 32, 32)
    from planet_tpu_torch.tools import lut, noise_stages, span_parts
    for tool in (noise_stages, lut, span_parts):
        assert tool.main(["--device", "cpu", "--small", "--reps", "1"]) == 0
    import torch.distributed as dist
    from planet_tpu_torch.cache import device_pool
    from planet_tpu_torch.parallel import facemesh, sharded, sharded_lod
    from planet_tpu_torch.nums import df as dfm
    with tempfile.TemporaryDirectory() as d:
        dist.init_process_group("gloo", init_method="file://" + d + "/store",
                                rank=0, world_size=1)
        mesh = sharded.make_mesh(1, device_type="cpu")
        pts = np.stack([facemesh.face_grid_points(f, 8, 6.371e6)
                        for f in range(6)])
        comps = [torch.from_numpy(a) for k in range(3)
                 for a in dfm.from_f64_np(pts[..., k])]
        h, sh, stats = sharded.sharded_field_step(mesh, octaves=2)(*comps)
        assert h.shape == (6, 8, 8) and float(stats[0]) == 6 * 64
        qmesh = sharded.make_mesh(1, axis="quads", device_type="cpu")
        render = sharded_lod.build_sharded_render(
            EngineConfig(), qmesh, 32, 24, cap=256, render_cap=64,
            gen_cap=64, max_lod=2, probe="zero")
        frame, _ = render(
            device_pool.init(64, 32, "cpu"),
            *dfm.from_f64_np(np.array([0.0, 0.0, -1.9113e7])),
            np.eye(4, dtype=np.float32))
        assert frame.n_leaves == 24 and not frame.overflowed
        dist.destroy_process_group()
    from planet_tpu_torch.engine import device_step
    tess = device_step.DeviceRenderer(EngineConfig(), 32, 24, device="cpu",
                                      stop_after="tess", cap=256,
                                      render_cap=64, gen_cap=64, max_lod=2)
    frame = tess.render(tess.init_pool(), *dfm.from_f64_np(
        np.array([0.0, 0.0, -1.9113e7])), np.eye(4, dtype=np.float32))
    assert frame.n_leaves == 6 and not frame.image.any()
    entry.dryrun_multichip(1, device="cpu")
    bad = sorted(m for m in sys.modules if m == "jax" or m.startswith("jax."))
    print(len(names), "modules;", "jax modules:", bad)
    ref = sorted(m for m in sys.modules
                 if m == "planet_tpu" or m.startswith("planet_tpu."))
    print("planet_tpu modules:", ref)
    assert not bad, bad
    assert not ref, ref
""")


def test_port_imports_no_jax():
    proc = subprocess.run([sys.executable, "-c", SCRIPT], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "jax modules: []" in proc.stdout
    assert "planet_tpu modules: []" in proc.stdout


def _imported(path: pathlib.Path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_port_sources_import_no_reference_package():
    files = sorted((ROOT / "planet_tpu_torch").rglob("*.py"))
    files += [ROOT / "chip_smoke.py", ROOT / "tests" / "torch_scenes.py",
              ROOT / "tests" / "torch_ranks.py"]
    bad = [(str(f.relative_to(ROOT)), m) for f in files for m in _imported(f)
           if m.split(".")[0] in ("jax", "planet_tpu")]
    assert len(files) > 40
    assert not bad, bad
