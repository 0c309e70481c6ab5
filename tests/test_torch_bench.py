"""The port's benchmark programs (rustic_tpu_torch/bench.py, bench_suite.py
and the CLI's `bench`) against the JAX package's (bench.py,
tools/bench_suite.py and rustic_tpu/cli.py), on the CPU at small sizes.

Both packages' defaults seed each pixel with the hash of its id
(RenderSettings.use_blue_noise is False in both), so the same frame
integrates the same samples on both sides and nothing needs pinning.
The JAX side renders with its CPU engine ("auto": the BVH or the
brute-force integrator), the port with its staged pipeline over the
kernels' plain versions. Both Worlds take the NumPy BVH builder (the JAX
one prefers its C++ builder, which orders triangles otherwise).

Tolerances: the headline's film within rtol 1e-4, atol 1e-5; the film
means of configs 1-4 within rtol 1e-4 (GlassTest's film at 32x16x2 has one
entry of 1,536 at 1.75e-4 relative between the two engines); the furnace
value within rtol 1e-6.
BreakTime (config 5; textures, normal maps, HDR sky; a 256-texel atlas on
both sides, as tests/test_torch_breaktime.py builds it) is held to that
file's rule: rtol 1e-4, atol 1e-5 on at least 98% of the pixels, every
pixel within rtol 2e-2, atol 1e-4, and the film means within 1e-5
relative.
"""

import ast
import importlib.util
import json
import os
import re
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

import rustic_tpu.runtime.render as jax_render
from rustic_tpu.config import NextEventEstimation as JaxNEE
from rustic_tpu.config import RenderSettings as JaxRenderSettings
from rustic_tpu.config import TracingConfig as JaxTracingConfig
from rustic_tpu.scene.gltf import load_glb as jax_load_glb
from rustic_tpu.scene.world import World as JaxWorld
from rustic_tpu_torch import bench, bench_suite, cli
from rustic_tpu_torch.scene.world import World
from tests.conftest import scene_path
from tests.test_torch_bvh_native import require_jax_native

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
W_, H_, SPP_ = 32, 16, 2
FILM_TOL = dict(rtol=1e-4, atol=1e-5)
ATLAS = 256
# the keys the port adds to bench.py's
PORT_KEYS = {"furnace_value", "launches", "pbr_skipped"}


@pytest.fixture(autouse=True)
def native_bvh_builder():
    """Both packages build their scenes in the default, native BVH order."""
    require_jax_native()


def load_tool(name, path):
    spec = importlib.util.spec_from_file_location(name, os.path.join(REPO, path))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope="module")
def jax_suite():
    return load_tool("jax_bench_suite", "tools/bench_suite.py")


def bench_py_result_keys():
    """The keys of bench.py's `result = {...}` literal."""
    with open(os.path.join(REPO, "bench.py")) as f:
        tree = ast.parse(f.read())
    for node in ast.walk(tree):
        if (isinstance(node, ast.Assign) and isinstance(node.value, ast.Dict)
                and [t.id for t in node.targets if isinstance(t, ast.Name)] == ["result"]):
            return {k.value for k in node.value.keys}
    raise AssertionError("bench.py has no result literal")


@pytest.fixture(scope="module")
def port_result():
    """One bench() run on the CPU: the headline at 32x16x2 and PBRTest at
    32x16x2."""
    return bench.bench(W_, H_, SPP_, device="cpu", pbr=(W_, H_, SPP_))


def test_configs_equal_the_tools_suite(jax_suite):
    assert bench_suite.CONFIGS == jax_suite.CONFIGS


def spy_films(monkeypatch, module, films, key):
    """Record every film `module.render_image` returns under films[key]."""
    real = module.render_image

    def spy(*a, **k):
        film = real(*a, **k)
        films[key] = np.asarray(film)
        return film

    monkeypatch.setattr(module, "render_image", spy)


@pytest.mark.parametrize("idx", [1, 2, 3, 4, 5])
def test_run_config_matches_jax(jax_suite, monkeypatch, idx):
    """Each BASELINE config shrunk to 32x16 at 2 spp through both
    packages' run_config: the record's fields and the timed render's film."""
    films = {}
    spy_films(monkeypatch, jax_render, films, "jax")  # run_config imports it from there
    spy_films(monkeypatch, bench, films, "port")  # the timed render's
    if idx == 5:
        monkeypatch.setattr(JaxWorld, "from_path",
                            classmethod(lambda cls, path: cls(jax_load_glb(path), ATLAS)))
        from_path = World.from_path.__func__
        monkeypatch.setattr(World, "from_path",
                            classmethod(lambda cls, path: from_path(cls, path, ATLAS)))
    spec = dict(bench_suite.CONFIGS[idx], size=(W_, H_), spp=SPP_)
    want = jax_suite.run_config(idx, spec, 1)
    got = bench_suite.run_config(idx, spec, 1, device="cpu")

    shared = ("config", "scene", "size", "spp", "backend")
    assert {k: got[k] for k in shared} == {k: want[k] for k in shared}
    assert set(want) < set(got)
    assert got["launches"] == {}  # the plain versions launch no kernel
    assert (got["tiles"] == 1) == (idx == 2)  # DarkCornell is one tile, the others many
    assert got["has_lights"]
    assert abs(got["film_mean"] - want["film_mean"]) <= 5e-6 + 1e-4 * abs(want["film_mean"])
    ours, theirs = films["port"], films["jax"]
    assert ours.shape == theirs.shape == (H_, W_, 3) and np.isfinite(ours).all()
    if idx < 5:
        np.testing.assert_allclose(ours.mean(), theirs.mean(), rtol=1e-4)
    else:
        close = np.isclose(ours, theirs, **FILM_TOL).all(axis=-1)
        assert close.mean() >= 0.98, close.mean()
        np.testing.assert_allclose(ours, theirs, rtol=2e-2, atol=1e-4)
        np.testing.assert_allclose(ours.mean(), theirs.mean(), rtol=1e-5)


def test_headline_matches_jax_render_image():
    """run_headline at 32x16x2 against the JAX render_image with bench.py's
    configuration."""
    head = bench.run_headline(W_, H_, SPP_, device="cpu")
    scene = JaxWorld.from_path(scene_path("DarkCornell.glb")).to_device()
    want = jax_render.render_image(
        scene, JaxTracingConfig(width=W_, height=H_, nee=JaxNEE.MIS),
        JaxRenderSettings(samples=SPP_))
    film = head["film"]
    assert film.shape == (H_, W_, 3) and np.isfinite(film).all() and film.mean() > 0.01
    np.testing.assert_allclose(film, want, **FILM_TOL)
    assert len(head["render_s_all"]) == bench.REPS
    assert head["render_s"] == sorted(head["render_s_all"])[1]
    assert head["cache_added"] == 0 and head["launches"] == {}


def test_furnace_probe_matches_jax(port_result):
    """The furnace probe against the JAX render_pixels on bench.py's
    arguments: both within 0.02 of 0.8."""
    scene = JaxWorld.from_path(scene_path("FurnaceTest.glb")).to_device()
    probe = np.asarray(jax_render.render_pixels(
        scene, JaxTracingConfig(width=128, height=128), np.array([65], np.int32),
        np.array([75], np.int32), 32))
    want = float((probe[0, 0] / 32) ** (1 / 2.2))
    assert abs(want - 0.8) < 0.02
    assert port_result["furnace_ok"] is True
    np.testing.assert_allclose(port_result["furnace_value"], want, rtol=1e-6)


def test_result_keys_match_bench_py(port_result):
    """bench.py's keys, with the build-cache counterparts meaning "nvcc ran
    in this process" (none here) against "loaded built kernels"."""
    assert set(port_result) == bench_py_result_keys() | PORT_KEYS
    r = port_result
    assert r["metric"] == f"DarkCornell {W_}x{H_}x{SPP_}spp camera-path throughput"
    assert r["unit"] == "Mpaths/s" and r["backend"] == "cpu"
    assert r["value"] > 0 and r["vs_baseline"] == r["value"] / bench.BASELINE_MPATHS
    assert (r["cache_entries_added"], r["compile_regime"], r["compile_was_cold"]) == (
        0, "warm", False)
    assert r["startup_s"] == r["scene_build_s"] + r["compile_s"]
    assert r["total_s"] >= r["startup_s"] + sum(r["render_s_all"])
    assert isinstance(r["pbr_multitile_mpaths"], float) and r["pbr_skipped"] is None
    assert r["launches"] == {}
    json.dumps(r)  # one JSON line


def test_missing_pbrtest_is_skipped_and_named(monkeypatch, tmp_path):
    """Only a missing PBRTest file skips the secondary rate, and the
    result names the file; a missing headline scene names its path."""
    monkeypatch.setattr(bench, "SCENES", str(tmp_path))
    assert bench.run_pbr(W_, H_, SPP_, device="cpu") is None
    with pytest.raises(FileNotFoundError, match=re.escape(str(tmp_path / "DarkCornell.glb"))):
        bench.run_headline(W_, H_, SPP_, device="cpu")
    monkeypatch.setattr(bench, "run_headline", lambda *a, **k: dict(
        scene_build_s=0.0, warmup_s=0.0, cache_added=0, render_s_all=[1.0], render_s=1.0,
        film=np.zeros((H_, W_, 3), np.float32), launches={}))
    monkeypatch.setattr(bench, "furnace_probe", lambda device: (0.8, True))
    r = bench.bench(W_, H_, SPP_, device="cpu")
    assert r["pbr_multitile_mpaths"] is None
    assert r["pbr_skipped"] == f"{tmp_path / 'PBRTest.glb'} not found"


def test_furnace_probe_failure_fails_bench(monkeypatch):
    """An exception in the furnace probe ends the bench: no result."""
    def broken(device):
        raise RuntimeError("furnace render failed")

    monkeypatch.setattr(bench, "furnace_probe", broken)
    monkeypatch.setattr(bench, "run_pbr", lambda *a, **k: pytest.fail("ran past the probe"))
    with pytest.raises(RuntimeError, match="furnace render failed"):
        bench.bench(W_, H_, SPP_, device="cpu")


def test_cli_bench_calls_the_ports_main(monkeypatch):
    calls = []
    monkeypatch.setattr(bench, "main", lambda argv: calls.append(argv) or 7)
    assert cli.main(["bench", "--spp", "12"]) == 7
    assert cli.main(["bench"]) == 7
    assert calls == [["--spp", "12"], ["--spp", "160"]]


def test_bench_and_suite_fail_without_cuda(monkeypatch, tmp_path):
    """No card: both programs raise before rendering, and nothing is
    recorded."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")  # the refusal needs its absence
    monkeypatch.setattr(bench, "HISTORY_PATH", str(tmp_path / "history.jsonl"))
    monkeypatch.setattr(bench, "LAST_PATH", str(tmp_path / "last.json"))
    for run in (bench.main, bench_suite.main, lambda argv: cli.main(["bench", *argv])):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            run(["--spp", "1"] if run is not bench_suite.main else ["--scale", "64"])
    assert os.listdir(tmp_path) == []


def test_suite_main_reports_a_failing_config_and_exits_nonzero(monkeypatch, tmp_path, capsys):
    def run_config(idx, spec, scale, device):
        if idx == 2:
            raise ValueError("config 2 broke")
        return dict(config=idx, scene=spec["scene"], mpaths_per_s=1.5, film_mean=0.5)

    monkeypatch.setattr(bench_suite, "resolve_device", lambda d: torch.device("cpu"))
    monkeypatch.setattr(bench_suite, "run_config", run_config)
    monkeypatch.setattr(bench, "host_info", lambda: {"git": None})
    out = tmp_path / "suite.json"
    assert bench_suite.main(["--configs", "1,2,3", "--out", str(out)]) == 1
    lines = [json.loads(line) for line in capsys.readouterr().out.splitlines()]
    assert lines[1] == dict(config=2, scene="DarkCornell.glb", error="ValueError: config 2 broke")
    assert lines[-1] == {"summary": {"FurnaceTest.glb": 1.5, "GlassTest.glb": 1.5}, "scale": 16}
    written = json.loads(out.read_text())
    assert written["scale"] == 16 and written["configs"] == lines[:3]


def test_record_keeps_card_results_only(monkeypatch, tmp_path):
    """A card's result is appended to build/bench_torch_history.jsonl and,
    at the full spec, written to build/bench_torch_last.json, with the
    machine it ran on; a host result is not recorded; the JAX package's
    bench_last.json and bench_history.jsonl are never written."""
    jax_files = {name: os.path.getmtime(os.path.join(REPO, name))
                 for name in ("bench_last.json", "bench_history.jsonl")}
    history, last = tmp_path / "h.jsonl", tmp_path / "l.json"
    monkeypatch.setattr(bench, "HISTORY_PATH", str(history))
    monkeypatch.setattr(bench, "LAST_PATH", str(last))
    info = {"card": "NVIDIA H100 80GB HBM3, 700.00 W", "git": "abc1234", "torch": "2.x",
            "cuda": "12.x", "cpu": "a CPU", "measured_at": "2026-01-01T00:00:00Z"}
    monkeypatch.setattr(bench, "host_info", lambda: info)
    bench.record({"backend": "cpu", "value": 1.0}, bench.SPP)
    assert not history.exists() and not last.exists()
    bench.record({"backend": "cuda", "value": 2.0}, 16)
    assert not last.exists()
    bench.record({"backend": "cuda", "value": 3.0}, bench.SPP)
    recs = [json.loads(line) for line in history.read_text().splitlines()]
    assert recs == [{"backend": "cuda", "value": 2.0} | info, {"backend": "cuda", "value": 3.0} | info]
    assert json.loads(last.read_text()) == recs[1]
    assert {name: os.path.getmtime(os.path.join(REPO, name)) for name in jax_files} == jax_files


def test_host_info_keys():
    info = bench.host_info()
    assert set(info) == {"measured_at", "git", "card", "torch", "cuda", "cpu"}
    assert info["torch"] == torch.__version__


def test_programs_run_without_jax_outside_the_checkout(tmp_path):
    """bench, bench_suite and the CLI import no jax, rustic_tpu, bench.py
    or tools module, and resolve their scenes against the repository from
    another working directory."""
    code = textwrap.dedent(
        """
        import sys
        for name in ("jax", "flax", "rustic_tpu", "tools", "archive", "bench"):
            sys.modules[name] = None
        import torch
        torch.set_num_threads(2)
        from rustic_tpu_torch import bench_suite, cli
        from rustic_tpu_torch import bench as port_bench
        spec = dict(bench_suite.CONFIGS[2], size=(8, 4), spp=1)
        r = bench_suite.run_config(2, spec, 1, device="cpu")
        assert r["film_mean"] > 0.0 and r["tiles"] == 1, r
        head = port_bench.run_headline(8, 4, 1, device="cpu")
        assert head["film"].shape == (4, 8, 3)
        assert not any(m in ("jax", "bench") or m.startswith(("jax.", "flax", "rustic_tpu.",
                                                              "tools", "archive"))
                       for m in sys.modules if sys.modules[m] is not None)
        print("ok")
        """
    )
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().endswith("ok")
