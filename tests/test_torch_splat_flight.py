"""The splat flight (the benchmark's lod-1080p-splat configuration,
perfbench/configs/lod-1080p-splat.json, under the flight traffic,
perfbench/traffic/flight.json) against its plain reference, on the CPU
with the kernels' plain versions.

* The reference's frozen splat (perfbench/reference/frozen/raster/
  splat.py) is the port's plain splat bit for bit on seeded random grids:
  upsample_cells' fragments, pack_keys' keys, splat_keys_plain, the hole
  fill and the back-face cull, at supersample 1, 2 and 8, wireframe on
  and off, with padding rows (invalid, NaN vertices) and NaN shades.
* DeviceInteractiveEngine's splat frame at the configuration's settings
  and caps equals perfbench/reference/lod_splat.frame within the
  configuration's limits (perfbench/drivers/lod.compare: leaf rows,
  tiles, clip-space vertices, image, depth, the pool's bookkeeping), from
  the empty pool and from the pool a short flight left; cut to a 96 x 54
  window at supersample 2, as the configuration's dry run is.
* reference/lod_splat, the frozen splat and the frozen S1 count import
  nothing of the port and no JAX (a fresh interpreter).
"""

import json
import pathlib
import subprocess
import sys

import pytest
import torch

from perfbench.drivers import lod as drv
from perfbench.harness import traffic
from perfbench.reference import lod_splat as ref_splat
from perfbench.reference.frozen.raster import splat as fsplat
from perfbench.reference.frozen.tess.vertex import PatchVertices as FPV
from planet_tpu_torch.engine import planet
from planet_tpu_torch.engine.config import EngineConfig
from planet_tpu_torch.geom.camera import Camera
from planet_tpu_torch.io.driver import DeviceInteractiveEngine
from planet_tpu_torch.raster import splat
from planet_tpu_torch.tess.vertex import PatchVertices

ROOT = pathlib.Path(__file__).resolve().parent.parent
CONF = json.loads((ROOT / "perfbench/configs/lod-1080p-splat.json")
                  .read_text())
FLIGHT = json.loads((ROOT / "perfbench/traffic/flight.json").read_text())
DRY = CONF["dry_run"]
SETTINGS = {**CONF["settings"], **DRY["settings"]}
CAPS = {**CONF["engine"], **DRY["engine"]}
W, H = SETTINGS["window_w"], SETTINGS["window_h"]


@pytest.fixture(scope="module", autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _grids(seed, q=6, g=9, w=40, h=30):
    """Seeded (Q, G, G) grids: clip positions around the screen (some
    behind the camera, some off it), shades in and out of [0, 1] with NaNs
    among them, validity with holes, and two padding rows (invalid, NaN
    positions), as DeviceRenderer's padding rows are."""
    gen = torch.Generator().manual_seed(seed)
    wv = torch.rand((q, g, g), generator=gen) * 4.0 - 0.2
    xyz = (torch.rand((q, g, g, 3), generator=gen) * 2.4 - 1.2) * wv[..., None]
    clip = torch.cat([xyz, wv[..., None]], -1)
    shade = torch.rand((q, g, g), generator=gen) * 1.4 - 0.2
    shade[torch.rand((q, g, g), generator=gen) < 0.05] = float("nan")
    valid = torch.rand((q, g, g), generator=gen) < 0.9
    clip[-2:] = float("nan")
    valid[-2:] = False
    world = torch.randn((q, g, g, 3), generator=gen)
    snormal = torch.randn((q, g, g, 3), generator=gen)
    return clip, shade, valid, world, snormal, w, h


@pytest.mark.parametrize("wireframe", [False, True])
@pytest.mark.parametrize("k", [1, 2, 8])
def test_frozen_splat_is_the_ports(k, wireframe):
    clip, shade, valid, world, snormal, w, h = _grids(100 * k + wireframe)
    if k > 1:
        assert fsplat.weights(k, wireframe) == splat.weights(k, wireframe)
    for a, b in zip(fsplat.upsample_cells(clip, shade, valid, k, wireframe),
                    splat.upsample_cells(clip, shade, valid, k, wireframe)):
        assert torch.equal(a.isnan(), b.isnan())
        assert torch.equal(a.nan_to_num(), b.nan_to_num())
    keys = fsplat.splat_keys_plain(clip, shade, valid, w, h, k, wireframe)
    assert torch.equal(keys, splat.splat_keys_plain(clip, shade, valid, w, h,
                                                    k, wireframe))
    assert int((keys != fsplat._EMPTY).sum()) > 0
    assert torch.equal(fsplat._fill_holes(keys), splat._fill_holes(keys))
    n = torch.zeros_like(world)
    pv, fpv = (cls(clip=clip, world=world, normal=n, height=shade,
                   snormal=snormal) for cls in (PatchVertices, FPV))
    assert torch.equal(fsplat.splat_valid(fpv, valid),
                       planet.splat_valid(pv, valid))


def _book(pool):
    return ref_splat.PoolBook(*(t.clone() for t in (
        pool.keys_lo, pool.keys_hi, pool.tick, pool.now)))


@pytest.mark.parametrize("start", ["empty pool", "after a flight"])
def test_splat_frame_equals_the_reference(start):
    fields = EngineConfig.__dataclass_fields__
    cfg = EngineConfig(**{k: v for k, v in SETTINGS.items() if k in fields})
    assert cfg.raster_mode == "splat" and cfg.raster_supersample == 2
    eng = DeviceInteractiveEngine(cfg, W, H, device="cpu", **CAPS)
    rcfg = ref_splat.engine_config(SETTINGS)
    path = traffic.make(FLIGHT, 2**33 + 17, rcfg.radius)
    frames = [0] if start == "empty pool" else [0, 20, 40]
    for k in frames:
        book = _book(eng.pool) if k else None
        pos, ang = path.at(k)
        _, image, depth = eng.render(Camera(pos, ang))
    assert eng.renderer.last_counters is None
    g = eng.renderer.last_geometry
    kept = dict(n=g.meta[0], leaf_lo=g.leaf_lo, leaf_hi=g.leaf_hi,
                leaf_depth=g.leaf_depth, tiles=g.tiles, clip=g.vertices.clip,
                image=image, depth=depth, after=_book(eng.pool))
    ref = ref_splat.frame(rcfg, W, H, CAPS, pos, ang, book, "cpu")
    assert ref.n_leaves > 100 and not ref.overflowed
    assert 0 < ref.covered < ref.filled <= W * H and ref.cells > 0
    got = drv.compare(kept, ref)
    assert all(v <= CONF["limits"][name] for name, v in got.items()), got


def test_the_splat_reference_imports_nothing_of_the_port():
    code = ("import sys; sys.path.insert(0, sys.argv[1]);"
            "import perfbench.reference.lod_splat;"
            "import perfbench.reference.frozen.raster.splat;"
            "import perfbench.harness.roofline_splat;"
            "print(sorted(m for m in sys.modules "
            "if m.split('.')[0].startswith('planet_tpu') or "
            "m.split('.')[0] in ('jax', 'jaxlib')))")
    out = subprocess.run([sys.executable, "-c", code, str(ROOT)],
                         capture_output=True, text=True, check=True)
    assert out.stdout.strip() == "[]"
