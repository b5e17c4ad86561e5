"""Build, load and launch the package's CUDA kernels.

The sources under planet_tpu_torch/csrc are compiled with nvcc, one
process per source, all started together, and linked into one shared
library with a plain C interface (no PyTorch headers, so a build takes
seconds) that is loaded with ctypes. The library lands in
planet_tpu_torch/_build/<hash>/, keyed by a hash of the sources, the
shared headers and the flags, and is built at first use: nothing is
compiled or loaded when a module is imported.

Flags keep the f32 arithmetic bit-compatible with the plain PyTorch
versions and with planet_tpu: -fmad=false (the double-float error-free
transforms break under FMA contraction), IEEE division and square root,
no fast-math.

Each C entry point takes raw pointers and the stream as void* and returns
cudaGetLastError(); `launch` raises if that is not cudaSuccess and counts
the launch in `launches` — one plain integer per kernel, which callers
reset and read to prove that a run went through the kernels.

Under a CUDA-graph capture a launch is recorded, not run: `captured`
takes the launches recorded inside its block back out of `launches` and
hands them to the graph's owner, which adds them back with `add_launches`
each time it replays the graph. So `launches` always counts kernels that
ran on the card.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import time

import torch

_PKG = pathlib.Path(__file__).resolve().parent
_SRC = _PKG / "csrc"
_BUILD = _PKG / "_build"

SOURCES = ("tile.cu", "raster.cu", "perlin.cu", "field.cu", "splat.cu",
           "refine.cu", "order.cu", "setup.cu", "tess.cu", "cache.cu",
           "uniforms.cu", "bench_noise.cu", "bench_lut.cu", "bench_span.cu")
HEADERS = ("noise.cuh", "tile_blend.cuh", "fragment.cuh", "uniforms.cuh")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-fmad=false", "-prec-div=true", "-prec-sqrt=true",
              "-Xptxas", "-v", "-Xcompiler", "-fPIC")

# C symbol -> ctypes argtypes (P = pointer or stream, I = int, F = float)
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    "planet_tiles": (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _F, _F,
                     _F, _P),
    "planet_route_records": (_P, _I, _P, _I, _P, _P, _P, _P),
    "planet_raster_span": (_P, _P, _I, _P, _I, _I, _I, _I, _P),
    "planet_raster_huge": (_P, _P, _I, _P, _I, _I, _I, _P),
    "planet_noise": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                     _F, _P),
    "planet_field": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _F,
                     _F, _F, _F, _F, _F, _F, _P),
    "planet_splat": (_P, _P, _P, _I, _I, _I, _I, _I, _I, _P, _P),
    "planet_refine_level": (_P,) * 5 + (_I,) + (_P,) * 15
                           + (_I, _I, _I, _I, _F, _F, _F, _F, _I, _P),
    "planet_dfs_order": (_P,) * 7 + (_I, _I) + (_P,) * 8,
    "planet_setup": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _F, _I, _P, _P,
                     _P, _P, _I, _P),
    "planet_clip_records": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _F, _P,
                            _P, _P, _P, _P),
    "planet_tess": (_P,) * 10 + (_I, _I, _I, _F, _F, _F) + (_P,) * 7,
    "planet_tess_rows": (_P,) * 8 + (_F,) + (_P,) * 5
                        + (_I, _I, _I, _F, _F, _F) + (_P,) * 7,
    "planet_cache": (_P,) * 10 + (_I,) * 5 + (_F, _F, _I) + (_P,) * 11,
    "planet_uniforms": (_P,) * 8 + (_I, _F) + (_P,) * 6,
    # the kernel-attribution tools (planet_tpu_torch/tools)
    "planet_t_noise": (_I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _F,
                       _P),
    "planet_t_tile": (_I, _P, _P, _P, _P, _P, _P, _I, _I, _F, _F, _F, _F, _P),
    "planet_t_lut": (_I, _P, _P, _P, _I, _I, _I, _I, _I, _P),
    "planet_t_span": (_I, _P, _P, _I, _P, _I, _I, _I, _I, _I, _P),
}

# kernel name -> launches so far (reset with reset_launches)
launches = {"tile": 0, "noise": 0, "gather": 0, "span": 0, "huge": 0,
            "field": 0, "splat": 0, "refine": 0, "order": 0, "setup": 0,
            "clip": 0, "tess": 0, "tess_wide": 0, "cache": 0,
            "uniforms": 0, "t_noise": 0, "t_tile": 0, "t_lut": 0,
            "t_span": 0}

_lib = None
build_info: dict = {}


def reset_launches():
    for k in launches:
        launches[k] = 0


def add_launches(tally: dict):
    """Count the launches of one replay of a captured graph."""
    for k, n in tally.items():
        launches[k] += n


@contextlib.contextmanager
def captured():
    """Wrap a CUDA-graph capture: yields a dict that, when the block
    exits, holds the launches recorded inside it per kernel, and leaves
    `launches` as it was before the block."""
    before = dict(launches)
    tally: dict = {}
    try:
        yield tally
    finally:
        for k in launches:
            tally[k] = launches[k] - before[k]
            launches[k] = before[k]


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME and os.path.exists(os.path.join(CUDA_HOME, "bin", "nvcc")):
        return os.path.join(CUDA_HOME, "bin", "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit (put nvcc on PATH or set CUDA_HOME)")


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES + HEADERS:
        h.update(name.encode())
        h.update((_SRC / name).read_bytes())
    return h.hexdigest()[:16]


def library():
    """The loaded kernel library, built on first use."""
    global _lib
    if _lib is not None:
        return _lib
    out_dir = _BUILD / _digest()
    so = out_dir / "libplanet_kernels.so"
    t0 = time.perf_counter()
    if not so.exists():
        out_dir.mkdir(parents=True, exist_ok=True)
        nvcc, tag = _nvcc(), os.getpid()
        objs = [out_dir / f"{s}.{tag}.o" for s in SOURCES]
        procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", str(o),
                                   str(_SRC / s)], stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
                 for s, o in zip(SOURCES, objs)]
        logs = [p.communicate()[0] for p in procs]
        tmp = out_dir / f"libplanet_kernels.{tag}.so"
        failed = [(s, p.returncode, log) for s, p, log in
                  zip(SOURCES, procs, logs) if p.returncode != 0]
        if not failed:
            link = subprocess.run([nvcc, "-shared", "-o", str(tmp),
                                   *map(str, objs)], capture_output=True,
                                  text=True)
            logs.append(link.stdout + link.stderr)
            if link.returncode != 0:
                failed.append(("link", link.returncode, logs[-1]))
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(
                f"{s} ({rc}):\n{log}" for s, rc, log in failed))
        os.replace(tmp, so)
        for o in objs:
            o.unlink()
        build_info["log"] = "".join(logs)
    build_info["seconds"] = time.perf_counter() - t0
    build_info["path"] = str(so)
    lib = ctypes.CDLL(str(so))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    _lib = lib
    return lib


def launch(kernel: str, symbol: str, *args):
    """Call C entry point `symbol` on the current stream (appended as the
    last argument); raise on a launch error; count the launch."""
    fn = getattr(library(), symbol)
    err = fn(*args, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"CUDA kernel {symbol} failed to launch: "
                           f"cudaError {err}")
    launches[kernel] += 1


def check_cuda(t: torch.Tensor, name: str, dtype, shape=None):
    """Wrapper-side validation of a kernel operand."""
    if t.device.type != "cuda":
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: expected {dtype}, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, "
                         f"got {tuple(t.shape)}")
