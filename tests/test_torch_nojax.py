"""planet_tpu_torch imports neither jax nor planet_tpu: in a fresh
interpreter, import every module of the package (the attribution tools
under planet_tpu_torch/tools included), render one tiny LOD frame and one
small cube-sphere field frame on the CPU, run the driver's non-interactive
loop and the three tools at their small sizes, then check sys.modules. And no source file of the
port, nor chip_smoke.py, names a jax or planet_tpu module in an import."""

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
    from planet_tpu_torch.tools import lut, noise_stages, span_parts
    for tool in (noise_stages, lut, span_parts):
        assert tool.main(["--device", "cpu", "--small", "--reps", "1"]) == 0
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
    files += [ROOT / "chip_smoke.py", ROOT / "tests" / "torch_scenes.py"]
    bad = [(str(f.relative_to(ROOT)), m) for f in files for m in _imported(f)
           if m.split(".")[0] in ("jax", "planet_tpu")]
    assert len(files) > 40
    assert not bad, bad
