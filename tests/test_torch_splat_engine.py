"""The engines' splat mode (raster_mode="splat") against planet_tpu's, on
the CPU.

* PlanetEngine at 96x72, supersample 2 and 4, wireframe on and off: its
  image and depth equal, bit for bit, planet_tpu's eager upsample_cells +
  splat_frame on the port's own clip, shade and valid (back faces culled,
  engine.planet.splat_valid);
* the same frames from the far camera against planet_tpu's PlanetEngine
  splat frame (its XLA path) at these bars: coverage agreement >= 0.999,
  shade within 1/1023 at all but 3 % of the pixels both cover, mean shade
  difference <= 0.3/1023. The two engines' vertices differ by a few f32
  ulps (the vertex program's blend products sum in another order than
  XLA's dot; this stays so with planet_tpu's own tiles carried into the
  port), and the splat's 21-bit NDC depth is hundreds of km deep here:
  most fragments of a pixel tie in depth and the key keeps the darkest, so
  an ulp changes the winner at a few pixels. `python
  tests/test_torch_splat_engine.py` prints the shares: 2.24-2.38 % of the
  covered pixels, mean 0.094-0.245/1023; planet_tpu's own jit and eager
  frames differ at 0 of them;
* DeviceRenderer in splat mode against PlanetEngine in splat mode on the
  same camera: from the far camera, image and depth bit for bit (wireframe
  on and off), and its splat on all its rows equal to the splat on its
  leaves' rows; from the frame golden's camera (210 leaves) the two differ
  only through the device step's f32 corner normals (planet_tpu's formula,
  ROADMAP's reference caveats): with PlanetEngine's normals taken the
  same way, bit for bit again.
"""
import pathlib
import types

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from planet_tpu.engine.config import EngineConfig as JEngineConfig
from planet_tpu.engine.planet import PlanetEngine as JEngine
from planet_tpu.raster import splat as jsplat
from planet_tpu_torch.engine import device_step, planet
from planet_tpu_torch.engine.config import EngineConfig
from planet_tpu_torch.engine.planet import (PlanetEngine, splat_raster,
                                            splat_valid)
from planet_tpu_torch.geom import camera as cam_mod
from planet_tpu_torch.geom import quadid as tq
from planet_tpu_torch.nums import df as tdf
from planet_tpu_torch.tess import mesh

torch.set_num_threads(1)
GOLD = pathlib.Path(__file__).parent / "goldens"
W, H = 96, 72


def _camera(pos, angles):
    return cam_mod.Camera(position=np.asarray(pos, np.float64),
                          angles=np.asarray(angles, np.float32))


# the far camera of the LOD goldens pitched at the planet centre (few
# leaves: planet_tpu's engine compiles one octave group), and the frame
# golden's camera (210 leaves)
FAR = _camera(np.load(GOLD / "lod_cams.npy")[2], (np.pi / 2, 0.0, 0.0))
FRAME = _camera(np.load(GOLD / "frame_cam.npy"),
                np.load(GOLD / "frame_angles.npy"))


def _bits(a):
    a = np.asarray(a)
    return a.view(np.int32) if a.dtype == np.float32 else a


def _splat_cfg(ss, **kw):
    return EngineConfig(window_w=W, window_h=H, raster_mode="splat",
                        raster_supersample=ss, **kw)


def _port_inputs(eng, out):
    """The port's own clip, shade and valid as its splat mode draws them
    (back faces culled)."""
    pv = out.vertices
    grid_mask = torch.from_numpy(mesh.grid_uv_skirt(
        eng.config.patch_verts)[3])
    valid = grid_mask[None].expand(out.n_leaves, -1, -1)
    w, n = pv.world, pv.snormal
    facing = ((w[..., 0] * n[..., 0] + w[..., 1] * n[..., 1])
              + w[..., 2] * n[..., 2]) < 0.0
    assert torch.equal(splat_valid(pv, valid), valid & facing)
    return pv.clip.numpy(), out.vertex_shade.numpy(), (valid & facing).numpy()


@pytest.fixture(scope="module")
def frame_engine_outputs():
    """PlanetEngine splat frames of the frame golden's camera, by
    (supersample, wireframe)."""
    res = {}
    for ss in (2, 4):
        eng = PlanetEngine(_splat_cfg(ss), device="cpu")
        for wf in (False, True):
            eng.wireframe = wf
            out, image, depth = eng.render(FRAME)
            res[ss, wf] = (eng, out, image.numpy(), depth.numpy())
    return res


@pytest.mark.parametrize("ss", [2, 4])
@pytest.mark.parametrize("wireframe", [False, True])
def test_engine_splat_is_planet_tpu_splat_on_its_inputs(
        frame_engine_outputs, ss, wireframe):
    eng, out, image, depth = frame_engine_outputs[ss, wireframe]
    assert eng.last_counters is None and out.n_leaves > 100
    clip, shade, valid = _port_inputs(eng, out)
    k = max(ss, 2) if wireframe else ss
    c, s, v = jsplat.upsample_cells(jnp.asarray(clip), jnp.asarray(shade),
                                    jnp.asarray(valid), k, wireframe=wireframe)
    jimage, jdepth = jsplat.splat_frame(c, s, v, W, H)
    np.testing.assert_array_equal(_bits(image), _bits(jimage))
    np.testing.assert_array_equal(_bits(depth), _bits(jdepth))
    assert np.isfinite(depth).mean() > 0.5


@pytest.fixture(scope="module")
def planet_tpu_far_frames():
    res = {}
    for ss in (2, 4):
        jeng = JEngine(JEngineConfig(window_w=W, window_h=H,
                                     raster_mode="splat",
                                     raster_supersample=ss,
                                     use_pallas=False))
        for wf in (False, True):
            jeng.wireframe = wf
            _, image, depth = jeng.render(FAR)
            res[ss, wf] = (np.asarray(image), np.asarray(depth))
    return res


def _agreement(image, depth, jimage, jdepth):
    """(coverage agreement, share of the screen both cover, share of those
    pixels whose shades differ by more than 1/1023, their mean shade
    difference in 1/1023)."""
    cov, jcov = np.isfinite(depth), np.isfinite(jdepth)
    both = cov & jcov
    ds = np.abs(image[both] - jimage[both]) * 1023
    return ((cov == jcov).mean(), both.mean(), (ds > 1.0 + 1e-3).mean(),
            ds.mean())


def _port_far_frame(ss, wireframe):
    eng = PlanetEngine(_splat_cfg(ss), device="cpu")
    eng.wireframe = wireframe
    _, image, depth = eng.render(FAR)
    return image.numpy(), depth.numpy()


@pytest.mark.parametrize("ss", [2, 4])
@pytest.mark.parametrize("wireframe", [False, True])
def test_engine_splat_frame_agrees_with_planet_tpu(planet_tpu_far_frames, ss,
                                                   wireframe):
    agree, both, off, mean = _agreement(*_port_far_frame(ss, wireframe),
                                        *planet_tpu_far_frames[ss, wireframe])
    assert agree >= 0.999, agree
    assert both > 0.3, "the view must show the planet"
    assert off <= 0.03, off
    assert mean <= 0.3, mean


def _device_frames(cfg, cam, wireframes, **caps):
    """DeviceRenderer splat frames of `cam` once no tile is left to
    generate, by wireframe, with the renderer."""
    r = device_step.DeviceRenderer(cfg, W, H, device="cpu", **caps)
    pool = r.init_pool()
    rot = cam_mod.camera_rotation(cam)
    pf = cam_mod.proj_factor_from_fovy(np.deg2rad(cfg.fovy_deg))
    vp = (cam_mod.perspective_lh(pf, W / H, cfg.near_plane, cfg.far_plane)
          @ cam_mod.view_from_rotation(rot)).astype(np.float32)
    args = (*tdf.from_f64_np(cam.position), vp)
    frames = {}
    for wf in wireframes:
        r.wireframe = wf
        for _ in range(3):
            frame = r.render(pool, *args)
            if frame.n_generated == 0:
                break
        assert frame.n_generated == 0 and not frame.overflowed
        assert r.last_counters is None
        frames[wf] = frame
    return r, frames


def test_device_renderer_splat_matches_planet_engine_splat():
    cfg = _splat_cfg(4)
    r, frames = _device_frames(cfg, FAR, (True, False), cap=256,
                               render_cap=64, gen_cap=64)
    eng = PlanetEngine(cfg, device="cpu")
    for wf, frame in frames.items():
        eng.wireframe = wf
        out, image, depth = eng.render(FAR)
        assert torch.equal(frame.image, image), wf
        assert torch.equal(frame.depth, depth), wf
        assert np.isfinite(depth.numpy()).mean() > 0.3
    # the last frame (wireframe off): the same leaves, and the splat on the
    # step's rows (padding rows invalid) equals the splat on its first n
    geom = r.last_geometry
    n = frame.n_leaves
    ids = tq.from_words(geom.leaf_lo[:n].numpy(), geom.leaf_hi[:n].numpy())
    np.testing.assert_array_equal(ids, out.leaf_ids)
    pv = geom.vertices
    img_n, dep_n = splat_raster(
        type(pv)(*(a[:n] for a in pv)), geom.vertex_shade[:n],
        geom.valid[:n], cfg, W, H)
    assert torch.equal(img_n, frame.image)
    assert torch.equal(dep_n, frame.depth)


def test_device_renderer_splat_differs_only_by_its_corner_normals(
        monkeypatch):
    """From the frame golden's camera the device step's f32 corner normals,
    (c_hi + c_lo) normalized in f32, move vertices by ulps against
    PlanetEngine's f64-normalized ones and change pixels of the splat;
    PlanetEngine with its corner normals taken the same way draws the
    device frame bit for bit."""
    cfg = _splat_cfg(4)
    _, frames = _device_frames(cfg, FRAME, (False, True), cap=1024,
                               render_cap=256, gen_cap=256)

    def f32_normals(corners):
        nrm = sum(torch.as_tensor(a) for a in tdf.from_f64_np(corners))
        return (nrm / torch.linalg.vector_norm(nrm, dim=-1,
                                               keepdim=True)).numpy()

    for wf, frame in frames.items():
        eng = PlanetEngine(cfg, device="cpu")
        eng.wireframe = wf
        _, image, _ = eng.render(FRAME)
        assert frame.n_leaves == 210
        assert not torch.equal(frame.image, image)
        with monkeypatch.context() as m:
            m.setattr(planet, "lod_refine", types.SimpleNamespace(
                refine=planet.lod_refine.refine,
                _normalize_rows=f32_normals))
            _, image, depth = eng.render(FRAME)
        assert torch.equal(frame.image, image), wf
        assert torch.equal(frame.depth, depth), wf


if __name__ == "__main__":
    # the shares behind the agreement bars: the port's far-camera frames
    # and planet_tpu's eager frames, each against planet_tpu's jit frames
    import jax

    jax.config.update("jax_platforms", "cpu")
    for ss in (2, 4):
        jeng = JEngine(JEngineConfig(window_w=W, window_h=H,
                                     raster_mode="splat",
                                     raster_supersample=ss,
                                     use_pallas=False))
        for wf in (False, True):
            jeng.wireframe = wf
            jit = [np.asarray(a) for a in jeng.render(FAR)[1:]]
            with jax.disable_jit():
                eager = [np.asarray(a) for a in jeng.render(FAR)[1:]]
            for name, frame in (("port", _port_far_frame(ss, wf)),
                                ("planet_tpu eager", eager)):
                agree, both, off, mean = _agreement(*frame, *jit)
                print(f"supersample {ss}, wireframe {wf}: {name} vs "
                      f"planet_tpu jit: coverage agreement {agree:.6f}, both "
                      f"cover {both:.4f} of the screen, shade off by more "
                      f"than 1/1023 at {off:.4%} of those pixels, mean "
                      f"{mean:.4f}/1023")
