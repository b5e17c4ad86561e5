"""Every public function and class of planet_tpu has its counterpart in
the port, or stands in LEFT_OUT with the reason it has none. The census
reads both packages' sources with `ast` and imports neither.

A planet_tpu module maps to the port's module of the same path, except
the Pallas kernel modules, whose counterparts are the CUDA wrappers
(RENAMED). A name found under another name or in another module of the
port stands in ELSEWHERE.
"""

import ast
import pathlib

import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent
REF, PORT = ROOT / "planet_tpu", ROOT / "planet_tpu_torch"

RENAMED = {
    "ops/kernels/field_pallas.py": "ops/kernels/field_cuda.py",
    "ops/kernels/perlin_pallas.py": "ops/kernels/perlin_cuda.py",
    "ops/kernels/tile_pallas.py": "ops/kernels/tile_cuda.py",
    "raster/coverage_pallas.py": "raster/coverage_cuda.py",
}
# (planet_tpu module, name) -> (port module, name)
ELSEWHERE = {
    ("nums/df.py", "from_f64"): ("nums/df.py", "from_f64_np"),
    ("ops/kernels/perlin_pallas.py", "accumulate_octaves"):
        ("ops/perlin.py", "accumulate_octaves"),
    ("raster/coverage.py", "raster_frame"):
        ("raster/coverage_cuda.py", "raster_frame"),
    # a rank holds one pool; planet_tpu stacks one a chip in one program
    ("parallel/sharded_lod.py", "init_pools"):
        ("cache/device_pool.py", "init"),
}
_TUPLES = "the port's double-floats are (hi, lo) tuples of tensors"
_FRACTION = ("the f32 24-bit fraction chain; the port takes each octave's "
             "48-bit fraction and fade in f64, as the C reference does "
             "(ROADMAP section 3; nums.df.shift_frac48)")
_PAYLOAD = ("the TPU's 128-lane row payload; K1 takes the DF corners and "
            "per-tile octave counts (tile_cuda.generate_tiles)")
LEFT_OUT = {
    ("nums/df.py", "DF"): _TUPLES,
    ("nums/df.py", "to_f32"): _TUPLES + " (a DF's f32 value is its hi)",
    ("nums/df.py", "jax_rsqrt"): "wraps lax.rsqrt; the port seeds the DF "
                                 "sqrt with the correctly rounded 1/sqrt",
    ("nums/df.py", "frac_m1"): _FRACTION,
    ("nums/df.py", "double_mod1"): _FRACTION,
    ("nums/df.py", "floor_split_ref"): _FRACTION,
    ("ops/kernels/tile_pallas.py", "build_payload_host"): _PAYLOAD,
    ("ops/kernels/tile_pallas.py", "tiles_from_payload"): _PAYLOAD,
    ("ops/kernels/tile_pallas.py", "tiles_mixed_octaves"): _PAYLOAD,
    ("raster/coverage_pallas.py", "raster_frame_auto"):
        "a TPU dispatcher between the XLA and Pallas rasters; the port has "
        "one raster (coverage_cuda.raster_frame)",
    ("raster/coverage_pallas.py", "raster_frame_pallas"):
        "the Pallas raster's driver with its TPU class caps; "
        "coverage_cuda.raster_frame drives K6, K2 and K3",
}


def _public(path: pathlib.Path) -> set:
    tree = ast.parse(path.read_text(), str(path))
    return {n.name for n in tree.body
            if isinstance(n, (ast.FunctionDef, ast.ClassDef))
            and not n.name.startswith("_")}


def _modules():
    return sorted(str(p.relative_to(REF)) for p in REF.rglob("*.py"))


@pytest.mark.parametrize("module", _modules())
def test_module_has_its_counterparts(module):
    port = PORT / RENAMED.get(module, module)
    assert port.exists(), f"no counterpart of planet_tpu/{module}"
    have = _public(port)
    for name in sorted(_public(REF / module)):
        key = (module, name)
        if key in LEFT_OUT:
            assert name not in have, f"{name} is ported: drop it from LEFT_OUT"
        elif key in ELSEWHERE:
            where, other = ELSEWHERE[key]
            assert other in _public(PORT / where), (key, ELSEWHERE[key])
        else:
            assert name in have, f"planet_tpu/{module}:{name} has no " \
                                 "counterpart in the port"


def test_tables_name_what_planet_tpu_has():
    for module, name in list(LEFT_OUT) + list(ELSEWHERE):
        assert name in _public(REF / module), (module, name)
    assert all(reason for reason in LEFT_OUT.values())
