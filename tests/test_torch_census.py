"""Every public function and class of planet_tpu has its counterpart in
the port, or stands in LEFT_OUT with the reason it has none. The census
reads both packages' sources with `ast` and imports neither.

A planet_tpu module maps to the port's module of the same path, except
the Pallas kernel modules, whose counterparts are the CUDA wrappers
(RENAMED). A name found under another name or in another module of the
port stands in ELSEWHERE. The root `__graft_entry__.py` maps to the port's
`entry.py`.

The keywords of planet_tpu's build_device_render and DeviceRenderer
stand in the port's (whose build_device_render forwards the rest to
build_geometry_step), in KEYWORDS_ELSEWHERE with what takes their place,
or in KEYWORDS_LEFT_OUT with the reason.
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


# planet_tpu's build_device_render keywords -> what the port has instead
KEYWORDS_ELSEWHERE = {
    # the untraced step: the port's build_device_render runs the step
    # eagerly (DeviceRenderer captures it, as jit=True compiles it)
    "jit": ("build_device_render", None),
    # the step always takes its roots as inputs (face_roots by default)
    "dynamic_roots": ("build_device_render", "roots"),
    # the packed framebuffer comes from raster_packed
    "raster_out": ("raster_packed", None),
}
KEYWORDS_LEFT_OUT = {
    "interpret": "Pallas interpret mode for the TPU kernels; the port's "
                 "kernels run their plain versions on CPU tensors",
    "raster_cfg": "the TPU raster's class caps (coverage_pallas."
                  "raster_frame_auto's keywords); the port has one raster, "
                  "coverage_cuda.raster_frame",
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


def test_graft_entry_has_its_counterparts():
    have = _public(PORT / "entry.py")
    names = _public(ROOT / "__graft_entry__.py")
    assert names == {"entry", "dryrun_multichip"}
    assert names <= have, names - have


def _keywords(path: pathlib.Path, func: str) -> set:
    """The keyword names of a module's function (or a class's __init__)."""
    tree = ast.parse(path.read_text(), str(path))
    for node in tree.body:
        if isinstance(node, ast.ClassDef) and node.name == func:
            node = next(n for n in node.body
                        if isinstance(n, ast.FunctionDef)
                        and n.name == "__init__")
        elif not (isinstance(node, ast.FunctionDef) and node.name == func):
            continue
        args = node.args
        return {a.arg for a in args.args + args.kwonlyargs} - {"self"}
    raise AssertionError(f"{path}: no {func}")


def test_device_step_keywords_have_their_counterparts():
    ref = REF / "engine" / "device_step.py"
    port = PORT / "engine" / "device_step.py"
    forwarded = _keywords(port, "build_geometry_step")
    have = _keywords(port, "build_device_render") | forwarded
    want = _keywords(ref, "build_device_render")
    assert "stop_after" in want and "stop_after" in have
    public = _public(port)
    for name in sorted(want):
        if name in KEYWORDS_LEFT_OUT:
            assert name not in have, f"{name} is ported: drop it"
        elif name in KEYWORDS_ELSEWHERE:
            func, keyword = KEYWORDS_ELSEWHERE[name]
            assert func in public, (name, func)
            assert keyword is None or keyword in have, (name, keyword)
        else:
            assert name in have, f"build_device_render's {name} has no " \
                                 "counterpart in the port"
    assert set(KEYWORDS_ELSEWHERE) | set(KEYWORDS_LEFT_OUT) <= want
    assert all(KEYWORDS_LEFT_OUT.values())
    renderer = _keywords(port, "DeviceRenderer") | forwarded
    assert (_keywords(ref, "DeviceRenderer") - {"cfg"}) <= renderer
    assert "stop_after" in renderer
