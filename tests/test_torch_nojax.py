"""planet_tpu_torch never imports jax: in a fresh interpreter, import every
module of the package, render one tiny frame on the CPU and run the
driver's non-interactive loop, then check sys.modules."""

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
    from planet_tpu.engine.config import EngineConfig
    from planet_tpu.geom import camera as cam_mod
    from planet_tpu_torch.engine.planet import PlanetEngine
    from planet_tpu_torch.io import driver
    eng = PlanetEngine(EngineConfig(window_w=64, window_h=48), device="cpu")
    cam = cam_mod.Camera(position=np.array([0.0, 0.0, -1.9113e7]),
                         angles=np.array([np.pi / 2, 0.0, 0.0], np.float32))
    out, image, depth = eng.render(cam)
    assert np.isfinite(depth.numpy()).mean() > 0.2
    with tempfile.TemporaryDirectory() as d:
        driver.main(["--frames", "1", "--width", "32", "--height", "24",
                     "--altitude", "2e7", "--backend", "cpu", "--no-save",
                     "--out", d])
        assert os.path.exists(os.path.join(d, "frame_0000.png"))
    bad = sorted(m for m in sys.modules if m == "jax" or m.startswith("jax."))
    print(len(names), "modules;", "jax modules:", bad)
    assert not bad, bad
""")


def test_port_imports_no_jax():
    proc = subprocess.run([sys.executable, "-c", SCRIPT], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "jax modules: []" in proc.stdout
