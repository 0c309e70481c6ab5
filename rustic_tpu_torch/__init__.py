"""rustic_tpu_torch — the PyTorch + CUDA port of rustic_tpu for NVIDIA Hopper.

The JAX package `rustic_tpu` is the reference this package is held
against (tests/test_torch_*.py). This package imports torch and numpy
only: never jax, flax or rustic_tpu, so it runs on a host that has none
of them.

What is ported is the single-tile kernel-shade slice: a scene with at
most 512 triangles (one flash tile), no textures, the procedural sky,
an alias light table of at most 16 entries, rendered by
runtime/render.py:render_image through runtime/pipeline.py. Four
hand-written CUDA kernels carry it (csrc/): the three flash scans and
the per-bounce shade kernel. Each has a plain PyTorch twin in the same
module; a wrapper runs the twin for CPU tensors and the kernel for CUDA
tensors.
"""

__version__ = "0.1.0"

from rustic_tpu_torch.config import (  # noqa: F401
    NextEventEstimation,
    RenderSettings,
    TracingConfig,
)
