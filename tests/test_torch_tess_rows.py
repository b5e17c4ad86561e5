"""V1's rows mode (planet_tpu_torch/tess/vertex_cuda.tessellate_rows): the
fused step's vertex program from the rows' id words and DF corners, the
uniforms computed in V1's own staging, on the CPU through its plain
version.

* On CPU tensors tessellate_rows equals U1's plain version followed by
  V1's (uniforms_plain, then tessellate_shaded_plain) bit for bit in all
  six outputs, on the cache cases' rows (torch_scenes.TESS_ROWS_CASES:
  padding rows past the live count, cropped rows of each child index,
  depths 0-5 and 0-29, every row cropped, the padding rows' zero words
  included); a padding row comes out NaN in every output but the height.
* The cases reach every branch of the uniforms: each child index among
  the cropped rows, the skirt at depths 0, 1 (max_skirt) and 2, 3
  (max_skirt / 4, / 8).
* The kernel's wrapper refuses CPU tensors and bad metadata: there is no
  fallback to the plain version on the card.
* The fused step calls U1 (uniforms_cuda.uniforms) on the "uniforms" rung
  alone and V1's rows mode once on the tess and geometry rungs, never the
  uniforms mode, so a geometry replay launches no U1.
* One copy of the uniforms' arithmetic: uniforms.cu and tess.cu include
  csrc/uniforms.cuh, which the build hashes, and neither writes the DF
  subtract or the skirt itself.

V1's rows mode on the card against both (bitwise) is a GPU test
(tests/test_torch_kernels_gpu.py::test_tess_rows_kernel_bitwise).
"""

import re

import pytest
import torch

from planet_tpu_torch import _cuda
from planet_tpu_torch.cache import device_pool as dp
from planet_tpu_torch.engine import device_step
from planet_tpu_torch.engine.config import EngineConfig
from planet_tpu_torch.tess import uniforms_cuda
from planet_tpu_torch.tess import vertex_cuda
import torch_ranks
from torch_scenes import TESS_ROWS_CASES, tess_rows

torch.set_num_threads(1)
FIELDS = ("clip", "world", "normal", "height", "snormal")


def _bits(t):
    return t.view(torch.int32)


@pytest.mark.parametrize("case", TESS_ROWS_CASES)
def test_rows_equal_u1_then_v1_plain(case):
    args, n = tess_rows(case)
    pv, shade = vertex_cuda.tessellate_rows(*args)
    (q_lo, q_hi, crop, depth, c_hi, c_lo, cam_hi, cam_lo, max_skirt, tiles,
     vp, grid) = args
    u = uniforms_cuda.uniforms_plain(q_lo, q_hi, crop, depth, c_hi, c_lo,
                                     cam_hi, cam_lo, max_skirt)
    want, want_shade = vertex_cuda.tessellate_shaded_plain(
        u.corners_rel, u.normals, tiles, u.vx, u.vy, u.skirt, vp, grid)
    for f in FIELDS:
        got_f = getattr(pv, f)
        assert torch.equal(_bits(got_f), _bits(getattr(want, f))), f
        assert bool(torch.isnan(got_f[n:]).all()) == (f != "height"), f
    assert torch.equal(_bits(shade), _bits(want_shade))
    assert bool(torch.isnan(shade[n:]).all())
    assert bool(torch.isfinite(pv.height).all())
    assert n < q_lo.shape[0]


def test_rows_reach_every_branch_of_the_uniforms():
    pairs, skirts = set(), {}
    for case in TESS_ROWS_CASES:
        args, _ = tess_rows(case)
        q_lo, q_hi, crop, depth, c_hi, c_lo, cam_hi, cam_lo, ms = args[:9]
        u = uniforms_cuda.uniforms_plain(q_lo, q_hi, crop, depth, c_hi,
                                         c_lo, cam_hi, cam_lo, ms)
        pairs |= set(zip(u.vx[crop].tolist(), u.vy[crop].tolist()))
        assert not bool(u.vx[~crop].any() or u.vy[~crop].any())
        for d, s in zip(depth.tolist(), u.skirt.tolist()):
            skirts.setdefault(d, set()).add(s)
    assert pairs == {(1, 1), (2, 1), (1, 2), (2, 2)}
    ms = torch.tensor(1500.0).item()
    want = {0: ms, 1: ms, 2: ms / 4, 3: ms / 8}
    for d, s in want.items():
        assert skirts[d] == {s}, (d, skirts[d])
    assert set(range(30)) <= set(skirts)


def test_rows_wrapper_refuses_what_it_cannot_launch():
    args, _ = tess_rows("budget")
    with pytest.raises(ValueError, match="CUDA tensor"):
        vertex_cuda.tessellate_rows_cuda(*args)
    with pytest.raises(ValueError, match="at most 32"):
        vertex_cuda.tessellate_rows_cuda(*args[:-1], 33)
    meta = torch.empty(3, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        vertex_cuda.tessellate_rows(*args[:9], meta, *args[10:])


@pytest.mark.parametrize("rung", device_step.STAGES)
def test_step_calls_u1_on_the_uniforms_rung_alone(monkeypatch, rung):
    cfg = EngineConfig(cache_capacity=256, generations_per_frame=6)
    calls = {"uniforms": 0, "rows": 0, "shaded": 0}

    def counting(key, fn):
        def wrapped(*a, **kw):
            calls[key] += 1
            return fn(*a, **kw)
        return wrapped

    monkeypatch.setattr(uniforms_cuda, "uniforms",
                        counting("uniforms", uniforms_cuda.uniforms))
    monkeypatch.setattr(vertex_cuda, "tessellate_rows",
                        counting("rows", vertex_cuda.tessellate_rows))
    monkeypatch.setattr(vertex_cuda, "tessellate_shaded",
                        counting("shaded", vertex_cuda.tessellate_shaded))
    step = device_step.build_geometry_step(
        cfg, device="cpu", cap=256, render_cap=64, gen_cap=16, max_lod=3,
        stop_after=rung)
    pool = dp.init(cfg.cache_capacity, cfg.tile_dim, "cpu")
    args = [torch.as_tensor(a)
            for a in torch_ranks.lod_camera_args(cfg, 96, 72, 1.6)]
    out = step(pool, *args, *device_step.face_roots(cfg.radius, "cpu"))
    assert int(out.meta[0]) > 6
    assert calls == {"uniforms": int(rung == "uniforms"),
                     "rows": int(rung in ("tess", "geometry")),
                     "shaded": 0}, calls


def test_one_copy_of_the_uniforms_arithmetic():
    assert "uniforms.cuh" in _cuda.HEADERS
    header = (_cuda._SRC / "uniforms.cuh").read_text()
    for name in ("two_sum", "df_sub_hi", "normal_len", "crop_variants",
                 "skirt_of"):
        assert re.search(rf"__device__ __forceinline__ \w+ {name}\(",
                         header), name
    for src in ("uniforms.cu", "tess.cu"):
        text = (_cuda._SRC / src).read_text()
        assert '#include "uniforms.cuh"' in text, src
        assert "exp2f" not in text and "two_sum(" not in text, src
        assert "df_sub_hi(" in text and "skirt_of(" in text, src
