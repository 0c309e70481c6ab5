"""The port's CLI (rustic_tpu_torch/cli.py) against the JAX package's
(rustic_tpu/cli.py), as tests/test_cli.py drives the JAX one: every
render goes through both `main`s with the same arguments, the port's on
the CPU (`main(argv, device="cpu")`), and the films written by
`--save-hdr` (or the checkpoints) are held together within rtol 1e-4,
atol 1e-5. Both packages' Worlds take the NumPy BVH builder (the JAX one
prefers its C++ builder, which orders triangles otherwise).

The renders share one configuration (DarkCornell 16x16, 2 bounces, NEE+MIS,
2 samples a step, `--engine brute`), so the JAX side compiles one program;
tests/test_torch_bvh.py holds the "bvh" engine's films, which "auto"
resolves to on the CPU, and the stats test renders "auto" on the port.
"""

import json
import os
import socket
import sys

import numpy as np
import pytest
import torch

from rustic_tpu import cli as jax_cli
from rustic_tpu_torch import cli
from rustic_tpu_torch.runtime.state import Checkpoint
from rustic_tpu_torch.utils.hdr import read_hdr
from tests.conftest import scene_path
from tests.test_torch_bvh_native import require_jax_native

torch.set_num_threads(2)

FILM_TOL = dict(rtol=1e-4, atol=1e-5)
BASE = ["--size", "16x16", "--bounces", "2", "--nee", "mis", "--sync-rate", "2", "--engine",
        "brute"]
STATS_KEYS = {"scene", "backend", "engine", "samples_resumed", "mpaths_per_s", "est_mrays_per_s",
              "spp_per_s", "render_s", "scene_build_s", "film_mean"}


@pytest.fixture(autouse=True)
def native_bvh_builder():
    """Both CLIs build their scenes in the default, native BVH order."""
    require_jax_native()


def render_args(tmp, tag, *extra, spp=2, scene="DarkCornell.glb"):
    return ["render", scene_path(scene), "--out", os.path.join(tmp, f"{tag}.png"),
            "--spp", str(spp), *BASE, *extra]


def both(tmp_path, tag, *extra, **kw):
    """Run the JAX CLI and the port's with the same arguments, each writing
    its film to <tag>_<package>.npy -> (port film, JAX film)."""
    films = []
    for pkg, run in (("port", lambda a: cli.main(a, device="cpu")), ("jax", jax_cli.main)):
        npy = os.path.join(tmp_path, f"{tag}_{pkg}.npy")
        assert run(render_args(str(tmp_path), f"{tag}_{pkg}", "--save-hdr", npy, *extra,
                               **kw)) == 0
        films.append(np.load(npy))
    return films


def test_cli_render_png_and_npy(tmp_path):
    from PIL import Image

    got, want = both(tmp_path, "one", "--tonemap", "aces_narkowicz")
    assert got.shape == (16, 16, 3) and got.dtype == np.float32 and np.isfinite(got).all()
    assert got.mean() > 0.01
    np.testing.assert_allclose(got, want, **FILM_TOL)
    png = Image.open(os.path.join(tmp_path, "one_port.png"))
    assert png.size == (16, 16)
    # the PNG holds the film tonemapped as the JAX CLI writes it: within one code
    ours = np.asarray(png, np.int16)
    theirs = np.asarray(Image.open(os.path.join(tmp_path, "one_jax.png")), np.int16)
    assert np.abs(ours - theirs).max() <= 1


def test_cli_render_hdr(tmp_path):
    hdr = {}
    for pkg, run in (("port", lambda a: cli.main(a, device="cpu")), ("jax", jax_cli.main)):
        hdr[pkg] = os.path.join(tmp_path, f"f_{pkg}.hdr")
        assert run(render_args(str(tmp_path), pkg, "--save-hdr", hdr[pkg])) == 0
    got, want = read_hdr(hdr["port"]), read_hdr(hdr["jax"])
    assert got.shape == (16, 16, 3)
    # RGBE: an 8-bit mantissa under a shared exponent, one code apart at most
    peak = np.maximum(want.max(axis=-1, keepdims=True), 1e-6)
    assert np.all(np.abs(got - want) <= peak / 128 + 1e-6)


def test_cli_camera_and_sun_flags(tmp_path):
    got, want = both(
        tmp_path, "cam", "--camera-pos", "0.3,1.2,-4", "--camera-rot", "0.1,0.2",
        "--sun", "1,2,0.5", "--sun-intensity", "10", "--specular-clamp", "0.2,0.8",
    )
    default = both(tmp_path, "default")[0]
    assert not np.allclose(got, default)  # the flags reached the render
    np.testing.assert_allclose(got, want, **FILM_TOL)


def test_cli_denoise(tmp_path):
    from rustic_tpu_torch.runtime.denoise import denoise

    got, want = both(tmp_path, "den", "--denoise")
    raw = both(tmp_path, "raw")[0]
    np.testing.assert_array_equal(got, denoise(raw, device="cpu"))
    np.testing.assert_allclose(got, want, **FILM_TOL)


@pytest.mark.parametrize("name, progressive", [("prog.npz", True), ("ckpt", False)])
def test_cli_checkpoint_resume(tmp_path, name, progressive):
    """--checkpoint saves the film and resumes from it when the file exists,
    with and without the .npz suffix (np.savez would append it to a bare
    path); the resumed film and the stats line's resumed count equal the
    JAX CLI's."""
    extra = ["--progressive"] if progressive else []
    ckpts, films, stats = {}, {}, {}
    for pkg, run in (("port", lambda a: cli.main(a, device="cpu")), ("jax", jax_cli.main)):
        ckpts[pkg] = os.path.join(tmp_path, pkg, name)
        os.makedirs(os.path.dirname(ckpts[pkg]))
        npy = os.path.join(tmp_path, f"{pkg}.npy")
        stats[pkg] = os.path.join(tmp_path, f"{pkg}.jsonl")
        for spp in (2, 4):
            argv = render_args(str(tmp_path), pkg, "--checkpoint", ckpts[pkg], "--save-hdr", npy,
                               "--stats-json", stats[pkg], *extra, spp=spp)
            assert run(argv) == 0
            assert os.path.exists(ckpts[pkg])
            assert Checkpoint.load(ckpts[pkg]).samples == spp
        films[pkg] = np.load(npy)
    np.testing.assert_allclose(films["port"], films["jax"], **FILM_TOL)
    port_ck, jax_ck = Checkpoint.load(ckpts["port"]), Checkpoint.load(ckpts["jax"])
    np.testing.assert_allclose(port_ck.film_sum, jax_ck.film_sum, **FILM_TOL)
    lines = {pkg: [json.loads(line) for line in open(path)] for pkg, path in stats.items()}
    assert [r["samples_resumed"] for r in lines["port"]] == [0, 2]
    assert [r["samples_resumed"] for r in lines["jax"]] == [0, 2]


def test_cli_stats_json_line(tmp_path):
    """One JSON record a render, with the JAX CLI's keys; "backend" is the
    render device's type, "engine" what "auto" resolved to."""
    recs = {}
    for pkg, run in (("port", lambda a: cli.main(a, device="cpu")), ("jax", jax_cli.main)):
        path = os.path.join(tmp_path, f"{pkg}.jsonl")
        assert run(render_args(str(tmp_path), pkg, "--stats-json", path)) == 0
        lines = [json.loads(line) for line in open(path)]
        assert len(lines) == 1
        recs[pkg] = lines[0]
    rec, jrec = recs["port"], recs["jax"]
    assert set(rec) == set(jrec) == STATS_KEYS
    assert rec["scene"] == "DarkCornell.glb" and rec["samples_resumed"] == 0
    assert rec["backend"] == "cpu" and rec["engine"] == jrec["engine"] == "brute"
    for key in ("mpaths_per_s", "spp_per_s", "render_s", "scene_build_s"):
        assert rec[key] > 0, key
    assert rec["film_mean"] == pytest.approx(jrec["film_mean"], rel=1e-4)
    path = os.path.join(tmp_path, "auto.jsonl")
    argv = render_args(str(tmp_path), "auto", "--stats-json", path, "--engine", "auto")
    assert cli.main(argv, device="cpu") == 0
    assert json.loads(open(path).read())["engine"] == "bvh"  # "auto" on the CPU


def test_cli_stats_to_stderr_and_off(tmp_path, capsys):
    assert cli.main(render_args(str(tmp_path), "a"), device="cpu") == 0
    lines = [l for l in capsys.readouterr().err.splitlines() if l.startswith("{")]
    assert len(lines) == 1 and json.loads(lines[0])["engine"] == "brute"
    assert cli.main(render_args(str(tmp_path), "b", "--stats-json", ""), device="cpu") == 0
    assert not [l for l in capsys.readouterr().err.splitlines() if l.startswith("{")]


@pytest.mark.parametrize("scene", ["DarkCornell.glb", "VeachMIS.glb"])
def test_cli_info_matches_jax(scene, capsys):
    assert cli.main(["info", scene_path(scene)]) == 0
    got = capsys.readouterr().out
    assert jax_cli.main(["info", scene_path(scene)]) == 0
    assert got == capsys.readouterr().out
    if scene == "VeachMIS.glb":
        assert "triangles:  2932" in got and "lights:     2880" in got


@pytest.mark.parametrize("extra", [
    [],
    ["--size", "24x8", "--bounces", "3", "--min-bounces", "1", "--nee", "direct", "--skybox",
     "sky.npy", "--camera-pos", "1,2,3", "--camera-rot=-0.5,2", "--sun", "0,3,4",
     "--sun-intensity", "2.5", "--specular-clamp", "0,1"],
])
def test_cli_config_matches_jax(extra):
    """Each flag lands in the TracingConfig field the JAX CLI puts it in."""
    argv = ["render", "x.glb", *extra]
    got = cli._make_config(cli.build_parser().parse_args(argv))
    want = jax_cli._make_config(jax_cli.build_parser().parse_args(argv))
    for field in ("width", "height", "min_bounces", "max_bounces", "nee", "has_skybox",
                  "cam_position", "cam_rotation", "sun_direction", "specular_weight_clamp"):
        assert getattr(got, field) == getattr(want, field), field
    if extra:
        assert got.min_bounces == 1 and got.sun_direction == (0.0, 0.6, 0.8, 2.5)


def test_cli_zero_sun_rejected():
    with pytest.raises(SystemExit):
        cli.main(["render", scene_path("DarkCornell.glb"), "--spp", "1", "--size", "8x8",
                  "--sun", "0,0,0"], device="cpu")


@pytest.mark.parametrize("argv", [
    ["render", "x.glb", "--dot", "f32"],
    ["render", "x.glb", "--device", "cpu"],
    ["bench", "--device", "cpu"],
])
def test_cli_has_no_tpu_flags(argv):
    """The MXU precision plan and a device flag are not the port's: the
    parser refuses them, on `render` and on `bench` (which runs on the card
    only; tests/test_torch_bench.py drives it)."""
    with pytest.raises(SystemExit):
        cli.build_parser().parse_args(argv)


def test_cli_sharded_world_of_one(tmp_path):
    """`--sharded` without torchrun is a world of one: the one-shot's film
    bit for bit, and the JAX CLI's `--sharded` film (its 8-device mesh)."""
    got, want = both(tmp_path, "sharded", "--sharded")
    one_shot = both(tmp_path, "one-shot")[0]
    np.testing.assert_array_equal(got, one_shot)
    np.testing.assert_allclose(got, want, **FILM_TOL)


def _cli_rank(rank: int, world: int, port: int, argv) -> None:
    """One rank of a `render --sharded` job as torchrun would start it."""
    os.environ.update(WORLD_SIZE=str(world), RANK=str(rank), LOCAL_RANK=str(rank),
                      MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
    torch.set_num_threads(1)
    sys.exit(cli.main(argv, device="cpu"))


def test_cli_sharded_two_ranks(tmp_path):
    """Two gloo ranks started as torchrun starts them: one 'spp' pair, each
    rank renders one of the two samples; rank 0 alone writes the PNG, the
    film and the stats line, and the film is the one-shot's within rtol
    1e-4 (the two samples summed in another order)."""
    from tests.test_torch_parallel import run_ranks

    with socket.socket() as s:  # a free port on this host for the rendezvous
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    npy, stats = os.path.join(tmp_path, "film.npy"), os.path.join(tmp_path, "stats.jsonl")
    argv = render_args(str(tmp_path), "ranks", "--sharded", "--save-hdr", npy, "--stats-json",
                       stats)
    run_ranks(_cli_rank, 2, (2, port, argv))
    assert sorted(os.listdir(tmp_path)) == ["film.npy", "ranks.png", "stats.jsonl"]
    lines = [json.loads(line) for line in open(stats)]
    assert len(lines) == 1 and set(lines[0]) == STATS_KEYS
    assert lines[0]["backend"] == "cpu" and lines[0]["engine"] == "brute"
    one_shot = os.path.join(tmp_path, "one.npy")
    assert cli.main(render_args(str(tmp_path), "one", "--save-hdr", one_shot), device="cpu") == 0
    np.testing.assert_allclose(np.load(npy), np.load(one_shot), **FILM_TOL)


def test_cli_render_refuses_an_absent_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.main(render_args(str(tmp_path), "x"))
    assert not os.path.exists(os.path.join(tmp_path, "x.png"))


def test_cli_compare(tmp_path, capsys):
    ref = os.path.join(tmp_path, "ref.npy")
    argv = ["compare", scene_path("DarkCornell.glb"), "--size", "8x8", "--spp", "1",
            "--reference", ref, "--reference-spp", "2"]
    assert cli.main(argv, device="cpu") == 0
    result = json.loads(capsys.readouterr().out)
    assert list(result["engines"]) == ["brute_vs_bvh", "brute_vs_flash", "bvh_vs_flash"]
    assert max(result["engines"].values()) < 1e-4
    assert os.path.exists(ref) and np.load(ref).shape == (8, 8, 3)
    assert set(result["reference"]) == {"rmse", "mae", "mean", "ref_mean"}
