"""pyproject.toml ships the whole port: every package of rustic_tpu_torch/
(each directory with an __init__.py), the kernel sources beside it, and
its console script; the JAX package's entries stay."""

import os
import tomllib

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def pyproject():
    with open(os.path.join(REPO, "pyproject.toml"), "rb") as f:
        return tomllib.load(f)


def test_every_port_package_is_listed():
    root = os.path.join(REPO, "rustic_tpu_torch")
    found = {
        os.path.relpath(d, REPO).replace(os.sep, ".")
        for d, _, files in os.walk(root)
        if "__init__.py" in files
    }
    assert {"rustic_tpu_torch", "rustic_tpu_torch.parallel", "rustic_tpu_torch.utils"} <= found
    listed = set(pyproject()["tool"]["setuptools"]["packages"])
    assert found <= listed, sorted(found - listed)


def test_kernel_sources_and_scripts_are_shipped():
    project = pyproject()
    data = project["tool"]["setuptools"]["package-data"]["rustic_tpu_torch"]
    # .cpp: the BVH builder and the image decoders' loops; .h: the AV1 tables they include
    assert {"csrc/*.cu", "csrc/*.cuh", "csrc/*.cpp", "csrc/*.h"} <= set(data)
    csrc = os.listdir(os.path.join(REPO, "rustic_tpu_torch", "csrc"))
    assert all(name.endswith((".cu", ".cuh", ".cpp", ".h")) for name in csrc), csrc
    assert "bvh_build.cpp" in csrc and "av1_tables.h" in csrc
    assert project["project"]["scripts"] == {
        "rustic-tpu": "rustic_tpu.cli:main",
        "rustic-tpu-torch": "rustic_tpu_torch.cli:main",
    }
    jax_packages = [p for p in project["tool"]["setuptools"]["packages"] if p.startswith("rustic_tpu.")]
    assert jax_packages == ["rustic_tpu.scene", "rustic_tpu.ops", "rustic_tpu.parallel",
                            "rustic_tpu.runtime", "rustic_tpu.utils"]
