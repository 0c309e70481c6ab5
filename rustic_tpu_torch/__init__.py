"""rustic_tpu_torch — the PyTorch + CUDA port of rustic_tpu for NVIDIA Hopper.

The JAX package `rustic_tpu` is the reference this package is held
against (tests/test_torch_*.py). This package imports torch and numpy
only: never jax, flax or rustic_tpu, so it runs on a host that has none
of them.

What is ported: the staged renderer of runtime/pipeline.py behind
runtime/render.py:render_image, for scenes of one triangle tile and of
many (textures, normal maps, HDR sky images), and the single-program
integrator of ops/trace.py with the flash, the brute-force and the BVH
engine, through hand-written CUDA kernels (csrc/): the flash scans of
one tile with the winner's shading row (K1-K3) and without (K12-K13),
and of many tiles, with tile lists (K5-K7), culled per ray in the kernel
(K9-K11), or so with the triangle table held in a thread-block cluster's
shared memory (K14-K16), the per-bounce shade kernel (K4, K8), the fused
bounce (K17), the dot-rate probes (K18, K19) and the BVH traversal, one
thread a ray (K20). Each has a plain PyTorch twin in the same module; a
wrapper runs the twin for CPU tensors and the kernel for CUDA tensors.
Scenes load from glTF, OBJ, STL, PLY and FBX (scene/); the quality-gate
programs are make_reference_films.py and quality_gate.py. The product
surface: the CLI (cli.py), progressive state and checkpoints
(runtime/state.py), the denoiser (runtime/denoise.py), the viewer's core
(runtime/viewer.py) and throughput counters and traces
(utils/profiling.py).
"""

__version__ = "0.1.0"

from rustic_tpu_torch.config import (  # noqa: F401
    NextEventEstimation,
    RenderSettings,
    TracingConfig,
)
