"""The port's float32 square root (planet_tpu_torch.nums.fp.sqrt_rn).

* sqrt_rn is the correctly rounded root (numpy's float32 np.sqrt) bit for
  bit on 2^16 seeded inputs at planet and unit scales. torch.sqrt on a float32 CPU tensor is not correctly
  rounded on every host, so this test fails there with a bare torch.sqrt.
* No module of the port takes a root any other way: a scan of the sources
  finds no call of sqrt, rsqrt, norm, vector_norm, normalize or hypot on
  torch or a tensor outside nums/fp.py (the DF root, nums.df.sqrt, takes
  its seed from sqrt_rn). numpy's roots (float64 host
  constants and cameras) are not the port's plain paths and stay.
* The kernels' sources (every file of _cuda.SOURCES and _cuda.HEADERS,
  csrc/uniforms.cuh among them) take their roots by sqrtf alone, the
  correctly rounded root under -prec-sqrt=true: no rsqrtf, hypotf,
  norm3df or the like, and no root intrinsic with another rounding.
"""

import ast
import pathlib
import re

import numpy as np
import pytest
import torch

from planet_tpu_torch import _cuda
from planet_tpu_torch.nums.fp import sqrt_rn

ROOT = pathlib.Path(__file__).resolve().parent.parent
N = 2**16
ROOTS = {"sqrt", "rsqrt", "sqrt_", "rsqrt_", "norm", "vector_norm",
         "normalize", "hypot"}
# modules whose names a root may be called on without being the port's
# float32 root: numpy and math on the host
HOST = {"np", "numpy", "math"}


def _inputs(scale):
    rng = np.random.default_rng(16)
    x = rng.uniform(0.0, 1.0, N) * scale
    # exact squares, their neighbours, the smallest and largest floats
    x[:64] = np.arange(64, dtype=np.float64) ** 2
    x = x.astype(np.float32)
    x[64:128] = np.nextafter(x[:64], np.float32(np.inf))
    x[128:132] = [np.finfo(np.float32).tiny, np.finfo(np.float32).max,
                  np.float32(1e-45), 0.0]
    return x


@pytest.mark.parametrize("scale", [1.0, 4.1e13, 6.4e6, 1e4])
def test_sqrt_rn_is_correctly_rounded(scale):
    x = _inputs(scale)
    got = sqrt_rn(torch.from_numpy(x))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy().view(np.int32),
                                  np.sqrt(x).view(np.int32))


def test_sqrt_rn_special_values_and_types():
    s = torch.tensor([-1.0, float("inf"), float("nan"), -0.0])
    out = sqrt_rn(s)
    assert out.dtype == torch.float32
    assert torch.isnan(out[0]) and out[1] == float("inf")
    assert torch.isnan(out[2]) and out[3] == 0.0
    assert torch.signbit(out[3])
    for dtype in (torch.float64, torch.float16):
        with pytest.raises(TypeError, match="float32 on the CPU"):
            sqrt_rn(s.to(dtype))


def _root_calls(path: pathlib.Path):
    """(line, call) for each call of a root function in a source file that
    is not made on numpy or math."""
    tree = ast.parse(path.read_text(), str(path))
    df_names = {a.asname or a.name for node in ast.walk(tree)
                if isinstance(node, ast.ImportFrom)
                and node.module == "planet_tpu_torch.nums"
                for a in node.names if a.name == "df"}
    for node in ast.walk(tree):
        if not (isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)
                and node.func.attr in ROOTS):
            continue
        base = node.func.value
        while isinstance(base, ast.Attribute):
            base = base.value
        if isinstance(base, ast.Name) and base.id in HOST | df_names:
            continue
        yield node.lineno, ast.unparse(node.func)


def test_the_port_takes_no_other_root():
    files = sorted((ROOT / "planet_tpu_torch").rglob("*.py"))
    assert len(files) > 40
    found = [(str(f.relative_to(ROOT)), line, call) for f in files
             for line, call in _root_calls(f)]
    # the one root: sqrt_rn's two torch.sqrt calls (on the card, and a
    # float32 CPU tensor's by float64), and by name the float64 host sites:
    # cubesphere.normalize is numpy's root of float64 face points
    allowed = [("planet_tpu_torch/nums/fp.py", "torch.sqrt")] * 2 + [
        ("planet_tpu_torch/parallel/facemesh.py", "cubesphere.normalize")]
    assert [(f, c) for f, _, c in found] == allowed, found


def test_the_scan_finds_roots(tmp_path):
    src = tmp_path / "m.py"
    src.write_text("import torch, numpy as np\n"
                   "a = torch.sqrt(x)\nb = x.rsqrt()\n"
                   "c = torch.linalg.vector_norm(x, dim=-1)\n"
                   "d = np.sqrt(2.0)\ne = np.linalg.norm(v)\n"
                   "f = torch.nn.functional.normalize(x)\n"
                   "from planet_tpu_torch.nums import df as dfm\n"
                   "g = dfm.sqrt((x, y))\n")
    assert [c for _, c in _root_calls(src)] == [
        "torch.sqrt", "x.rsqrt", "torch.linalg.vector_norm",
        "torch.nn.functional.normalize"]


# CUDA's root functions and intrinsics other than sqrtf: approximate
# (rsqrtf, __frsqrt_rn's reciprocal), or rounded otherwise than torch's
# root (__fsqrt_rz and the like), or roots of sums in their own order
CUDA_ROOTS = re.compile(r"\b(sqrtf|rsqrtf|hypotf|rhypotf|norm3df|rnorm3df|"
                        r"norm4df|rnorm4df|normf|rnormf|cbrtf|rcbrtf|"
                        r"__fsqrt_r[nzud]|__frsqrt_rn|sqrt|rsqrt)\s*\(")


def _cuda_roots(text: str) -> list:
    """The root calls of a CUDA source, comments left out."""
    text = re.sub(r"//[^\n]*", "", text)
    return CUDA_ROOTS.findall(text)


def test_the_kernels_take_their_roots_by_sqrtf():
    names = _cuda.SOURCES + _cuda.HEADERS
    assert "uniforms.cuh" in names
    found = {n: _cuda_roots((_cuda._SRC / n).read_text()) for n in names}
    assert {r for roots in found.values() for r in roots} == {"sqrtf"}
    # the header's one root, the corner normal's (U1 and V1's rows mode)
    assert found["uniforms.cuh"] == ["sqrtf"]
    assert _cuda_roots("a = rsqrtf(x); b = sqrtf(y); // hypotf(z)\n"
                       "c = __fsqrt_rd(w);") == ["rsqrtf", "sqrtf",
                                                 "__fsqrt_rd"]
