"""Each C entry point of planet_tpu_torch/csrc takes the argument types that
_cuda._SIGNATURES hands to ctypes. ctypes cannot check a call against the
C declaration, so a parameter added to or dropped from one side only would
pass garbage to the kernel on the card; this reads the declarations on the
CPU instead."""

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
