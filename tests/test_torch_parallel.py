"""The port's multi-GPU layer (rustic_tpu_torch/parallel/shard.py) on the
CPU, case by case as tests/test_parallel.py holds the JAX one.

One job of four ranks (spawned processes, gloo, a file:// rendezvous in
a temporary directory) runs every case once for the module; each rank
writes its results and the tests read them. The scenes come from the
JAX package's arrays through scene_from_arrays, so both packages render
the same triangles (and BVH: "auto" is the BVH engine on the CPU). The
configuration is tests/test_parallel.py's: 16x16, NEE+MIS, 2 bounces.

Tolerances are tests/test_parallel.py's: a pixel split changes no
lane's arithmetic, a sample split changes the order of the film's sums
(and a pixel split the sample fold of the staged pipeline), so the
sharded films are held to the single-device films of both packages at
rtol 1e-4 / atol 1e-5 for render_sharded (the integrator) and 2e-5 /
2e-6 for render_sharded_staged, and FurnaceTest's px-only split at 1e-5 /
1e-6.
"""

import datetime
import multiprocessing
import os

import numpy as np
import pytest
import torch
import torch.distributed as dist

from rustic_tpu_torch.config import NextEventEstimation, RenderSettings, TracingConfig
from rustic_tpu_torch.parallel import make_mesh, render_sharded, sharded_step
from rustic_tpu_torch.parallel.shard import assemble_film, make_px_mesh, render_sharded_staged
from rustic_tpu_torch.runtime.render import (
    pixel_offsets,
    pixel_tensor,
    render_image,
    render_pixels,
    u32_bits,
)
from rustic_tpu_torch.scene.world import scene_from_arrays

torch.set_num_threads(2)

WORLD = 4
CPUS = ["cpu"] * WORLD
CONFIG = dict(width=16, height=16, max_bounces=2, nee=NextEventEstimation.MIS)
SHARDED = dict(samples=4, use_blue_noise=True)  # render_sharded's settings
STAGED = dict(samples=4)  # render_sharded_staged's on DarkCornell
FURNACE = dict(samples=2)  # and on FurnaceTest
RAGGED = dict(width=15, height=13)  # 195 pixels: padded to 196 over 4 ranks
STEP_PIXELS = 64
JOB_TIMEOUT_S = 120
INTEGRATOR_TOL = dict(rtol=1e-4, atol=1e-5)
STAGED_TOL = dict(rtol=2e-5, atol=2e-6)

FIELDS = ("tri_feats16", "tri_attrs", "entry_rows", "tile_aabbs", "bvh_min", "bvh_max",
          "bvh_left_first", "bvh_count")
META = ("n_tris", "n_alias_entries", "has_lights", "has_glass", "has_textures")


def scene_fields(scene) -> dict:
    """The JAX SceneArrays as the numpy fields scene_from_arrays takes."""
    out = {k: np.asarray(getattr(scene, k)) for k in FIELDS}
    return out | {k: getattr(scene, k) for k in META}


def step_pixels():
    """tests/test_parallel.py's 64 pixels for sharded_step, offsets 0."""
    i = np.arange(STEP_PIXELS, dtype=np.int32)
    return i % 16, i // 16 % 16, np.zeros(STEP_PIXELS, np.uint32)


# ---- the four ranks ---------------------------------------------------------------------


def _rank_cases(out_dir: str) -> dict:
    """Every case on this rank -> name -> array."""
    cornell, furnace = (scene_from_arrays(np.load(os.path.join(out_dir, f"{name}.npz")), "cpu")
                        for name in ("cornell", "furnace"))
    config = TracingConfig(**CONFIG)
    out = {}

    # samples that do not split over 'spp': ValueError on every rank, before
    # any collective, so the job goes on
    mesh = make_mesh(CPUS, spp_parallel=2)  # 2 x 2, also for the cases below
    raised = []
    for call in (lambda: sharded_step(mesh, config.static_part(), 3),
                 lambda: render_sharded_staged(cornell, config, RenderSettings(samples=3), mesh)):
        try:
            call()
            raised.append(False)
        except ValueError:
            raised.append(True)
    alive = torch.ones(1)
    dist.all_reduce(alive)
    out["indivisible"] = np.array(raised + [float(alive) == WORLD])

    # the shards in rank order: over the world without a mesh, over 'px'
    # with one (the 'spp' peers of a 2 x 2 mesh hold the same shard)
    mine = torch.full((2, 3), float(dist.get_rank()))
    out["gather_world"] = assemble_film(mine)
    out["gather_px"] = assemble_film(mine, mesh)

    for name, spp in (("default", None), ("1", 1), ("2", 2), ("4", 4)):
        m = make_mesh(CPUS, spp_parallel=spp)
        out[f"mesh_{name}"] = np.array([m.size("px"), m.size("spp"), m.index("px"),
                                        m.index("spp")])

    for spp in (1, 2, 4):
        out[f"sharded_{spp}"] = render_sharded(cornell, config, RenderSettings(**SHARDED),
                                               mesh=make_mesh(CPUS, spp_parallel=spp))

    # sharded_step twice over this rank's shard of 64 pixels, 2 samples a call
    fn = sharded_step(mesh, config.static_part(), n_samples=2)
    b = STEP_PIXELS // mesh.size("px")
    lo = mesh.index("px") * b
    px, py, off = (a[lo:lo + b] for a in step_pixels())
    lanes = (pixel_tensor(px, "cpu"), pixel_tensor(py, "cpu"), u32_bits(off, "cpu"))
    cam = config.dynamic_part("cpu")
    film1 = fn(cornell, cam, *lanes, 0, torch.zeros((b, 3)))
    film2 = fn(cornell, cam, *lanes, 2, film1)
    out["step1"], out["step2"] = assemble_film(film1, mesh), assemble_film(film2, mesh)

    out["staged_px"] = render_sharded_staged(cornell, config, RenderSettings(**STAGED),
                                             mesh=make_px_mesh(CPUS))
    out["staged_px_spp"] = render_sharded_staged(cornell, config, RenderSettings(**STAGED),
                                                 mesh=mesh)
    out["furnace_px"] = render_sharded_staged(furnace, config, RenderSettings(**FURNACE),
                                              mesh=make_px_mesh(CPUS))
    out["ragged"] = render_sharded_staged(cornell, config.replace(**RAGGED),
                                          RenderSettings(**STAGED), mesh=make_px_mesh(CPUS))
    return out


def _rank_main(rank: int, out_dir: str) -> None:
    """One rank of the job: the scenes from <out_dir>/<name>.npz, its
    results into <out_dir>/rank<r>.npz."""
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{out_dir}/rendezvous", rank=rank,
                            world_size=WORLD, timeout=datetime.timedelta(seconds=60))
    try:
        np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **_rank_cases(out_dir))
    finally:
        dist.destroy_process_group()


def run_ranks(target, world: int, args, timeout_s: float = JOB_TIMEOUT_S) -> None:
    """Start `world` spawned processes target(rank, *args) and wait for all;
    any rank that fails or outlives the timeout fails the job. Keep `args`
    small: a start blocks until the child has read them, after its imports."""
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=target, args=(rank, *args)) for rank in range(world)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(timeout_s)
    hung = [rank for rank, p in enumerate(procs) if p.is_alive()]
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join()
    assert not hung, f"ranks {hung} did not finish in {timeout_s} s"
    assert [p.exitcode for p in procs] == [0] * world


@pytest.fixture(scope="module")
def scenes(cornell_scene, furnace_scene):
    return {"cornell": scene_fields(cornell_scene), "furnace": scene_fields(furnace_scene)}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory, scenes):
    out = tmp_path_factory.mktemp("ranks")
    for name, fields in scenes.items():
        np.savez(out / f"{name}.npz", **fields)
    run_ranks(_rank_main, WORLD, (str(out),))
    return [dict(np.load(out / f"rank{r}.npz")) for r in range(WORLD)]


def same_on_every_rank(ranks, key):
    film = ranks[0][key]
    for r in ranks[1:]:
        np.testing.assert_array_equal(r[key], film)
    return film


# ---- single-device references -------------------------------------------------------------


@pytest.fixture(scope="module")
def port_cornell(scenes):
    return scene_from_arrays(scenes["cornell"], "cpu")


@pytest.fixture(scope="module")
def jax_config():
    from rustic_tpu.config import TracingConfig as JaxTracingConfig

    return JaxTracingConfig(**CONFIG)


def jax_staged(scene, jax_config, samples):
    """The JAX package's single-device render_batch_staged mean film."""
    import jax.numpy as jnp

    from rustic_tpu.runtime import pipeline as P

    w, h = CONFIG["width"], CONFIG["height"]
    y, x = np.mgrid[0:h, 0:w]
    film = P.render_batch_staged(
        scene, jax_config.static_part(), jax_config.dynamic_part(),
        jnp.asarray(x.reshape(-1), jnp.int32), jnp.asarray(y.reshape(-1), jnp.int32),
        jnp.asarray(pixel_offsets(w, h, False)), 0, samples,
    )
    return np.asarray(film).reshape(h, w, 3) / samples


# ---- the cases of tests/test_parallel.py -------------------------------------------------


def test_four_ranks_finish(ranks):
    assert len(ranks) == WORLD


def test_mesh_shapes(ranks):
    """Ranks in row-major order over ('px', 'spp'); spp_parallel 2 by
    default on an even world."""
    for rank, res in enumerate(ranks):
        assert res["mesh_default"].tolist() == [2, 2, rank // 2, rank % 2]
        assert res["mesh_1"].tolist() == [4, 1, rank, 0]
        assert res["mesh_2"].tolist() == [2, 2, rank // 2, rank % 2]
        assert res["mesh_4"].tolist() == [1, 4, 0, rank]


def test_mesh_needs_a_device_a_rank_and_a_divisor():
    with pytest.raises(ValueError, match="devices for a world of 1"):
        make_mesh(CPUS)
    with pytest.raises(ValueError, match="does not divide"):
        make_mesh(["cpu"], spp_parallel=2)
    mesh = make_mesh(["cpu"])  # no process group: a world of one
    assert mesh.shape == {"px": 1, "spp": 1} and mesh.device_mesh is None
    assert make_px_mesh(["cpu"]).shape == {"px": 1}


@pytest.fixture(scope="module")
def sharded_references(port_cornell, cornell_scene, jax_config):
    """(the port's single-device film, JAX's render_sharded film on its
    8-device mesh) at render_sharded's settings."""
    from rustic_tpu.config import RenderSettings as JaxRenderSettings
    from rustic_tpu.parallel.shard import make_mesh as jax_make_mesh
    from rustic_tpu.parallel.shard import render_sharded as jax_render_sharded

    single = render_image(port_cornell, TracingConfig(**CONFIG), RenderSettings(**SHARDED),
                          device="cpu", engine="auto")
    jax_film = jax_render_sharded(cornell_scene, jax_config, JaxRenderSettings(**SHARDED),
                                  mesh=jax_make_mesh())
    return single, np.asarray(jax_film)


@pytest.mark.parametrize("spp_parallel", [1, 2, 4])
def test_sharded_matches_single_device(ranks, sharded_references, spp_parallel):
    """The sampler is a pure function of (pixel, sample): the split cannot
    change the film beyond the order of its sums."""
    single, jax_film = sharded_references
    film = same_on_every_rank(ranks, f"sharded_{spp_parallel}")
    assert film.shape == (16, 16, 3) and film.mean() > 0.01
    np.testing.assert_allclose(film, single, **INTEGRATOR_TOL)
    np.testing.assert_allclose(film, jax_film, **INTEGRATOR_TOL)


def test_sharded_step_film_accumulates(ranks, port_cornell):
    film1 = same_on_every_rank(ranks, "step1")
    film2 = same_on_every_rank(ranks, "step2")
    assert film2.shape == (STEP_PIXELS, 3) and np.isfinite(film2).all()
    assert film2.sum() > film1.sum() * 1.2
    px, py, off = step_pixels()
    want = render_pixels(port_cornell, TracingConfig(**CONFIG), px, py, 4, offsets=off)
    np.testing.assert_allclose(film2, want.numpy(), **INTEGRATOR_TOL)


def test_assemble_film_gathers_in_rank_order(ranks):
    for rank, res in enumerate(ranks):
        np.testing.assert_array_equal(res["gather_world"][:, 0], [0, 0, 1, 1, 2, 2, 3, 3])
        spp_index = rank % 2
        np.testing.assert_array_equal(res["gather_px"][:, 0],
                                      [spp_index] * 2 + [2 + spp_index] * 2)


def test_assemble_film_single_process():
    """Without a process group the assembly is the identity."""
    film = np.arange(12, dtype=np.float32).reshape(4, 3)
    np.testing.assert_array_equal(assemble_film(film), film)
    np.testing.assert_array_equal(assemble_film(torch.from_numpy(film), make_px_mesh(["cpu"])),
                                  film)


@pytest.fixture(scope="module")
def staged_references(port_cornell, cornell_scene, jax_config):
    single = render_image(port_cornell, TracingConfig(**CONFIG), RenderSettings(**STAGED),
                          device="cpu")
    return single, jax_staged(cornell_scene, jax_config, STAGED["samples"])


@pytest.mark.parametrize("key", ["staged_px", "staged_px_spp"])
def test_sharded_staged_matches_single_device(ranks, staged_references, key):
    """The staged pipeline over a ('px',) mesh of 4 and a ('px', 'spp')
    mesh of 2 x 2 against the single-device staged film of both packages."""
    single, jax_film = staged_references
    film = same_on_every_rank(ranks, key)
    assert film.mean() > 0.01
    np.testing.assert_allclose(film, single, **STAGED_TOL)
    np.testing.assert_allclose(film, jax_film, **STAGED_TOL)


def test_sharded_staged_furnace_px_mesh(ranks, scenes):
    """A multi-tile scene (FurnaceTest, 20 tiles) through the default
    multi-tile loop on every rank of a ('px',) mesh."""
    furnace = scene_from_arrays(scenes["furnace"], "cpu")
    single = render_image(furnace, TracingConfig(**CONFIG), RenderSettings(**FURNACE),
                          device="cpu")
    film = same_on_every_rank(ranks, "furnace_px")
    assert film.mean() > 0.01
    np.testing.assert_allclose(film, single, rtol=1e-5, atol=1e-6)


def test_sharded_staged_pads_the_last_shard(ranks, port_cornell):
    """A frame the 'px' axis does not divide: the padded lanes are cut
    off after the gather."""
    single = render_image(port_cornell, TracingConfig(**CONFIG | RAGGED),
                          RenderSettings(**STAGED), device="cpu")
    film = same_on_every_rank(ranks, "ragged")
    assert film.shape == (13, 15, 3)
    np.testing.assert_allclose(film, single, **STAGED_TOL)


def test_indivisible_samples_raise_on_every_rank(ranks):
    """sharded_step and render_sharded_staged with 3 samples over an 'spp'
    axis of 2 raise ValueError on every rank, and every rank reaches the
    next collective."""
    for res in ranks:
        assert res["indivisible"].tolist() == [True, True, True]
