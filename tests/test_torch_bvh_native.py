"""The port's BVH builders against the JAX package's (scene/bvh.py).

`build_bvh` runs csrc/bvh_build.cpp, the port's copy of native/bvh.cpp,
built by g++ with the JAX package's flags; the JAX package builds its
BVH with native/bvh.cpp by default (rustic_tpu/scene/bvh_native.py). On
one host the two libraries give the same bits: nodes and permutation
equal. `use_native=False` is the NumPy builder, equal to JAX's
`_build_bvh_numpy`. Where g++ is missing the port raises (JAX falls back
to NumPy without a word).

`require_jax_native` is the guard the port's tests call before they hold
a port World to a JAX World built by default: under pytest-xdist several
workers may run the JAX package's first-use build into the same
native/libbvh.so at once, and one that finds a partial file loses the
native builder for the rest of its process while JAX's `build_bvh` falls
back to NumPy without a word. The guard loads it again once the build
has settled, and fails, with that message, if it stays unavailable."""

import os
import subprocess
import sys
import time

import numpy as np
import pytest

from rustic_tpu.scene import bvh as JB
from rustic_tpu.scene import bvh_native
from rustic_tpu_torch.ops import _build
from rustic_tpu_torch.scene import bvh as TB
from rustic_tpu_torch.scene.gltf import load_glb
from tests.conftest import scene_path

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCENES = ["DarkCornell", "FurnaceTest", "GlassTest", "VeachMIS", "PBRTest", "BreakTime"]
NODE_FIELDS = ("aabb_min", "aabb_max", "left_first", "count")


def require_jax_native(wait_s: float = 120.0) -> None:
    """Fail unless the JAX package's native BVH builder is loaded, so that
    a JAX World built by default is in the native order."""
    deadline = time.monotonic() + wait_s
    while True:
        try:
            if bvh_native.available():
                return
        except OSError:  # a partial libbvh.so: another worker is still building it
            pass
        if time.monotonic() > deadline:
            pytest.fail("the JAX package's native BVH builder (native/libbvh.so) is not available, "
                        "so its build_bvh falls back to the NumPy order: a concurrent build by "
                        "another test worker left a partial file, or g++ failed")
        time.sleep(1.0)
        bvh_native._TRIED = False  # load it again


def assert_same_bvh(got, want):
    (bvh, perm), (jbvh, jperm) = got, want
    for name in NODE_FIELDS:
        a, b = getattr(bvh, name), getattr(jbvh, name)
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    assert perm.dtype == jperm.dtype == np.int64
    np.testing.assert_array_equal(perm, jperm)


@pytest.mark.parametrize("name", SCENES)
def test_builders_equal_the_jax_builders(name):
    """The C++ builder equals JAX's native one bit for bit, the NumPy one
    JAX's NumPy one; the two orders differ from each other."""
    require_jax_native()
    g = load_glb(scene_path(f"{name}.glb"))
    native = TB.build_bvh(g.positions, g.triangles)
    assert_same_bvh(native, bvh_native.build_bvh(g.positions, g.triangles, 128))
    numpy_ = TB.build_bvh(g.positions, g.triangles, use_native=False)
    assert_same_bvh(numpy_, JB._build_bvh_numpy(g.positions, g.triangles, 128))
    assert not np.array_equal(native[1], numpy_[1])
    tris = np.asarray(g.triangles, np.int64)
    verts = np.asarray(g.positions, np.float32)[:, :3]
    tri_min = np.minimum(np.minimum(verts[tris[:, 0]], verts[tris[:, 1]]), verts[tris[:, 2]])
    tri_max = np.maximum(np.maximum(verts[tris[:, 0]], verts[tris[:, 1]]), verts[tris[:, 2]])
    TB.validate_bvh(native[0], tri_min[native[1]], tri_max[native[1]])


@pytest.mark.parametrize("sah_samples", [2, 16, 64])
def test_native_builder_takes_the_bin_count(sah_samples):
    require_jax_native()
    rng = np.random.default_rng(sah_samples)
    verts = rng.normal(size=(300, 3)).astype(np.float32)
    tris = np.concatenate([rng.integers(0, 300, (200, 3)), np.zeros((200, 1), np.int64)], 1)
    assert_same_bvh(TB.build_bvh(verts, tris, sah_samples),
                    bvh_native.build_bvh(verts, tris, sah_samples))


def test_library_lands_under_build():
    TB.build_bvh(np.eye(3, dtype=np.float32), np.array([[0, 1, 2, 0]]))
    lib = _build.compile_host(os.path.join(_build.CSRC, "bvh_build.cpp"))
    assert os.path.dirname(lib) == os.path.join(REPO, "build")
    assert os.path.basename(lib).startswith("libbvh_build-") and lib.endswith(".so")
    assert TB._native_library()._name == lib


def test_missing_compiler_raises_naming_it(tmp_path, monkeypatch):
    """No silent fallback: without g++ (and no library built yet) the
    port's build_bvh raises and names the compiler."""
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    TB._native_library.cache_clear()
    try:
        with pytest.raises(RuntimeError, match=r"g\+\+"):
            TB.build_bvh(np.eye(3, dtype=np.float32), np.array([[0, 1, 2, 0]]))
        assert not (tmp_path / "build").exists()
    finally:
        TB._native_library.cache_clear()
    bvh, perm = TB.build_bvh(np.eye(3, dtype=np.float32), np.array([[0, 1, 2, 0]]),
                             use_native=False)
    assert bvh.n_nodes == 1 and perm.tolist() == [0]


def test_failing_compiler_raises_its_message(tmp_path, monkeypatch):
    src = tmp_path / "broken.cpp"
    src.write_text("int f( {\n")
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path / "build"))
    with pytest.raises(RuntimeError, match=r"g\+\+ failed to build .*broken.cpp"):
        _build.compile_host(str(src))
    assert not list((tmp_path / "build").glob("*.so"))


def test_empty_scene_is_refused():
    for native in (True, False):
        with pytest.raises(ValueError, match="no triangle"):
            TB.build_bvh(np.zeros((0, 3), np.float32), np.zeros((0, 4), np.int64),
                         use_native=native)


def test_building_imports_no_jax(tmp_path):
    """A World built by the port (the native builder) from another working
    directory imports nothing of JAX or the JAX package."""
    code = ("import sys; from rustic_tpu_torch.scene.world import World; "
            f"w = World.from_path({scene_path('GlassTest.glb')!r}); "
            "bad = [m for m in sys.modules "
            "if m == 'jax' or m.startswith(('jax.', 'rustic_tpu.'))]; "
            "assert not bad, bad; print(w.bvh.n_nodes)")
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) > 1
