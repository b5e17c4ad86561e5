"""Each C entry point of planet_tpu_torch/csrc takes the argument types that
_cuda._SIGNATURES hands to ctypes. ctypes cannot check a call against the
C declaration, so a parameter added to or dropped from one side only would
pass garbage to the kernel on the card; this reads the declarations on the
CPU instead. And each entry point is launched by a module of the package:
none is built for nothing. And chip_smoke.py, the port's check on the
card, runs every `gpu`-marked test and names every kernel that
_cuda.launches counts."""

import ast
import importlib.util
import pathlib
import re

import pytest

from planet_tpu_torch import _cuda

_C_TYPES = {"void*": _cuda._P, "int": _cuda._I, "float": _cuda._F}


def _declarations() -> dict:
    """{symbol: (ctypes type, ...)} of every `extern "C" int name(...)` in
    the package's CUDA sources."""
    out = {}
    for name in _cuda.SOURCES:
        text = (_cuda._SRC / name).read_text()
        for sym, params in re.findall(r'extern "C" int (\w+)\(([^)]*)\)',
                                      text):
            types = []
            for param in params.split(","):
                words = param.replace("const ", "").split()
                ctype = " ".join(words[:-1]).replace(" *", "*")
                if words[-1].startswith("*"):
                    ctype += "*"
                types.append(_C_TYPES[ctype])
            out[sym] = tuple(types)
    return out


@pytest.mark.parametrize("symbol", sorted(_cuda._SIGNATURES))
def test_ctypes_signature_matches_the_c_declaration(symbol):
    decls = _declarations()
    assert symbol in decls, f"{symbol} is not declared in csrc/"
    assert _cuda._SIGNATURES[symbol] == decls[symbol]


def test_every_entry_point_has_a_signature():
    assert set(_declarations()) == set(_cuda._SIGNATURES)


def _launched_symbols(tools: bool) -> set:
    """The string constants of the package's modules that call
    _cuda.launch (the C entry points they launch), of the attribution
    tools (planet_tpu_torch/tools) or of the other modules."""
    out = set()
    for path in _cuda._PKG.rglob("*.py"):
        if path.name == "_cuda.py" or (path.parent.name == "tools") != tools:
            continue
        tree = ast.parse(path.read_text(), str(path))
        if not any(isinstance(n, ast.Attribute) and n.attr == "launch"
                   for n in ast.walk(tree)):
            continue
        out |= {n.value for n in ast.walk(tree)
                if isinstance(n, ast.Constant) and isinstance(n.value, str)}
    return out


def test_every_entry_point_is_launched_by_the_package():
    """A C entry point that no module of the package launches is a kernel
    the library builds for nothing: each symbol of _SIGNATURES is named in
    a module that calls _cuda.launch — the attribution tools' kernels
    (csrc/bench_*.cu) in planet_tpu_torch/tools, every other source's
    outside it, so a main-path source carries no entry point that only a
    tool launches."""
    bench = {sym for name in _cuda.SOURCES if name.startswith("bench_")
             for sym in re.findall(r'extern "C" int (\w+)\(',
                                   (_cuda._SRC / name).read_text())}
    assert bench and bench <= set(_cuda._SIGNATURES)
    tools, others = _launched_symbols(True), _launched_symbols(False)
    assert bench <= tools, bench - tools
    main = set(_cuda._SIGNATURES) - bench
    assert main <= others, main - others


def _chip_smoke():
    root = pathlib.Path(__file__).resolve().parents[1]
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  root / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return root, mod


def _marks_gpu(path: pathlib.Path) -> bool:
    return any(isinstance(n, ast.Attribute) and n.attr == "gpu"
               and isinstance(n.value, ast.Attribute) and n.value.attr == "mark"
               for n in ast.walk(ast.parse(path.read_text(), str(path))))


def test_chip_smoke_runs_every_gpu_test_file():
    """chip_smoke.py runs the files of GPU_TESTS on the card: every port
    test file that marks a test `gpu` is one of them, and each of them
    marks some."""
    root, smoke = _chip_smoke()
    marked = {str(f.relative_to(root))
              for f in sorted((root / "tests").glob("test_torch_*.py"))
              if _marks_gpu(f)}
    assert marked == set(smoke.GPU_TESTS)


def test_chip_smoke_names_every_counted_kernel():
    """Each kernel that _cuda.launches counts has a row in chip_smoke's
    kernels line: its source is one of the library's, and its planet_tpu
    counterpart a file of the reference package or of its tools."""
    root, smoke = _chip_smoke()
    assert set(smoke.SOURCES) == set(_cuda.launches)
    for name, (src, replaces) in smoke.SOURCES.items():
        assert src.startswith("csrc/") and src[5:] in _cuda.SOURCES, name
        for ref in replaces.split(", "):
            assert (root / ref.split(":")[0]).is_file(), (name, ref)
