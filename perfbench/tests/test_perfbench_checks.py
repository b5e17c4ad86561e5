"""The correctness check and the run's guards, driven through the
harness's own entry (perfbench/run.py, --dry-run: the CPU at the
configurations' dry_run sizes through the port's plain path):

* sound runs come out correct, and the control (the reference in the
  precision below the configuration's in the program's place) does not;
* with the timed path broken underneath, `correct` comes out false, once
  for each fault a cell of this benchmark can have: a step that leaves its
  state unchanged, half of the batch left out, an answer altered where it
  is produced (one cell is one chip: there is no exchange between chips
  to leave out);
* no module of JAX or of the JAX package is loaded, compared by whole
  top-level names;
* a measurement run without a card exits non-zero and prints no result;
* a cell is added by adding files alone."""

import contextlib
import io
import json
import os
import shutil
import subprocess
import sys

import pytest
import torch

from perfbench.harness import cli, nojax

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
LOD, FIELD = "lod-1080p.flight", "field-6x2048.regen"


def _run(workload, *extra, seed=2**31 + 11, seconds=1.5):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = cli.main(["--workload", workload, "--seed", str(seed),
                       "--seconds", str(seconds), "--trace", "0",
                       "--dry-run", *extra], ROOT, t_start=0.0)
    assert rc == 0
    return json.loads(out.getvalue().strip().splitlines()[-1])


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("workload", [LOD, FIELD, "lod-1080p.lookaround"])
def test_sound_runs_are_correct(workload):
    line = _run(workload)
    assert line["correct"] is True and line["failed"] == 0
    assert line["attempted"] > 0 and line["metrics"] == {}
    assert list(line)[-1] == "checks"


@pytest.mark.parametrize("workload", [LOD, FIELD])
def test_the_control_is_not_correct(workload):
    line = _run(workload, "--control")
    assert line["correct"] is False
    assert any(v["value"] > v["limit"] for v in line["checks"].values())


# ---- faults planted in the program
def _state_unchanged_lod(mp):
    from planet_tpu_torch.cache import device_pool
    mp.setattr(device_pool, "store", lambda *a, **k: None)


def _half_batch_lod(mp):
    from planet_tpu_torch.raster import coverage_cuda
    real = coverage_cuda.raster_frame

    def half(clip, normal, valid, *a, **k):
        valid = valid.clone()
        valid[1::2] = False
        return real(clip, normal, valid, *a, **k)
    mp.setattr(coverage_cuda, "raster_frame", half)


def _answer_altered_lod(mp):
    from planet_tpu_torch.ops.kernels import tile_cuda
    real = tile_cuda.generate_tiles

    def altered(*a, **k):
        t = real(*a, **k)
        t[0] += 0.5
        return t
    mp.setattr(tile_cuda, "generate_tiles", altered)


def _state_unchanged_field(mp):
    from planet_tpu_torch.ops.kernels import field_cuda
    real, first = field_cuda.field_cube, []

    def stale(*a, **k):
        if not first:
            first.append(real(*a, **k))
        return first[0]
    mp.setattr(field_cuda, "field_cube", stale)


def _half_batch_field(mp):
    from planet_tpu_torch.ops.kernels import field_cuda
    real = field_cuda.field_cube

    def half(*a, **k):
        h, s = real(*a, **k)
        h[3:], s[3:] = 0.0, 0.0
        return h, s
    mp.setattr(field_cuda, "field_cube", half)


def _answer_altered_field(mp):
    from planet_tpu_torch.ops.kernels import field_cuda
    real = field_cuda.field_cube

    def altered(*a, **k):
        h, s = real(*a, **k)
        h[2, 5, 7] += 1.0
        return h, s
    mp.setattr(field_cuda, "field_cube", altered)


@pytest.mark.parametrize("workload,fault", [
    (LOD, _state_unchanged_lod), (LOD, _half_batch_lod),
    (LOD, _answer_altered_lod), (FIELD, _state_unchanged_field),
    (FIELD, _half_batch_field), (FIELD, _answer_altered_field)],
    ids=["lod-state", "lod-half", "lod-answer", "field-state",
         "field-half", "field-answer"])
def test_a_fault_is_not_correct(workload, fault, monkeypatch):
    fault(monkeypatch)
    assert _run(workload)["correct"] is False


# ---- guards
def test_nojax_compares_whole_top_level_names():
    assert nojax.loaded(["planet_tpu_torch", "planet_tpu_torch.io",
                         "jaxtyping", "numpy"]) == []
    assert nojax.loaded(["planet_tpu.ops", "jax.numpy", "jaxlib", "flax",
                         "planet_tpu_torch"]) == [
        "flax", "jax.numpy", "jaxlib", "planet_tpu.ops"]


def _script(args, cwd=ROOT, env=None):
    return subprocess.run([sys.executable, "perfbench/run.py", *args],
                          cwd=cwd, capture_output=True, text=True,
                          env={**os.environ, **(env or {})}, timeout=300)


def test_a_run_loads_no_jax():
    code = ("import sys, runpy; sys.argv = ['run.py', '--workload', "
            f"'{LOD}', '--seed', '5', '--seconds', '1', '--trace', '0', "
            "'--dry-run']; sys.path.insert(0, '.');\n"
            "try:\n    runpy.run_path('perfbench/run.py', "
            "run_name='__main__')\nexcept SystemExit:\n    pass\n"
            "from perfbench.harness import nojax; print('LOADED', "
            "nojax.loaded())")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert "LOADED []" in out.stdout, out.stdout[-2000:] + out.stderr[-2000:]


def test_a_measurement_run_without_a_card_fails():
    if torch.cuda.is_available():
        pytest.skip("a card is present: this checks the run without one")
    out = _script(["--workload", LOD, "--seed", "1", "--seconds", "1",
                   "--trace", "0"], env={"CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_a_cell_is_added_by_files_alone(tmp_path):
    """A copy of the benchmark gains a cell, `lod-1080p.hover` (a camera
    holding still 5 km up), by a new traffic file and a new entry in
    BENCHMARK.json; no file of the harness changes."""
    shutil.copytree(os.path.join(ROOT, "perfbench"), tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
    bench["workloads"].append({
        "name": "lod-1080p.hover", "config": "lod-1080p",
        "traffic": "hover", "chips": 1, "why": "a camera holding still"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    hover = {"generator": "camera_path", "warmup_frames": 2,
             "orbit": {"latitude_sin": 0.2, "theta_step": 0.0},
             "altitude": {"high": 5000.0, "low": 5000.0, "period": 2},
             "pitch": 0.2, "rotate": True}
    (tmp_path / "perfbench" / "traffic" / "hover.json").write_text(
        json.dumps(hover))
    out = _script(["--workload", "lod-1080p.hover", "--seed", "8",
                   "--seconds", "1", "--trace", "0", "--dry-run"],
                  cwd=tmp_path, env={"PYTHONPATH": ROOT})
    assert out.returncode == 0, out.stderr[-3000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] is True and line["attempted"] > 0


def test_a_checkout_without_the_program_fails(tmp_path):
    shutil.copytree(os.path.join(ROOT, "perfbench"), tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run(
        [sys.executable, "perfbench/run.py", "--workload", LOD,
         "--seed", "1", "--seconds", "1", "--trace", "0", "--dry-run"],
        cwd=tmp_path, capture_output=True, text=True, timeout=300, env=env)
    assert "planet_tpu_torch" in out.stderr
    assert out.returncode != 0 and '"correct"' not in out.stdout


@pytest.mark.gpu
def test_one_short_run_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    out = _script(["--workload", LOD, "--seed", "12", "--seconds", "2",
                   "--trace", "0"])
    assert out.returncode == 0, out.stderr[-3000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] is True and line["device"]["platform"] == "gpu"
