"""Synchronous rendering (twin of rustic_tpu/runtime/render.py).

`render_image(scene, config, settings, device)` renders a full frame on
`device`, through the CUDA kernels when it is a CUDA device and through
their plain PyTorch versions when it is the CPU. A CUDA device that is
absent is an error, never a silent fall back to the CPU.

`engine` names the intersection engine (ops/intersect.py: "auto",
"flash", "brute", "bvh") or None. None is the staged pipeline
(runtime/pipeline.py) on the scene's device. An engine goes through the
staged pipeline when it resolves to "flash" on a CUDA device and through
the single-program integrator (ops/trace.py `accumulate_samples`)
otherwise, as in the JAX package: "auto" is "flash" on a CUDA device and
"brute" or "bvh" by triangle count on the CPU; `engine="brute"` and
`engine="bvh"` are the oracles. `render_pixels` takes "auto" by default,
as the JAX package's does; `render_image` takes None (the staged
pipeline) unless an engine is named. `backend="cpu"` renders on the host
whatever device the scene is on.
"""

from __future__ import annotations

import functools
import os
from typing import Optional

import numpy as np
import torch

from rustic_tpu_torch.config import CameraParams, RenderSettings, StaticConfig, TracingConfig
from rustic_tpu_torch.ops.intersect import _pick_engine, cpu_engine
from rustic_tpu_torch.ops.rng import as_i32_bits, pcg_hash
from rustic_tpu_torch.ops.trace import accumulate_samples
from rustic_tpu_torch.runtime.pipeline import render_batch_staged
from rustic_tpu_torch.scene.world import SceneTensors

_BLUENOISE = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "assets", "bluenoise_128.npy",
)


@functools.lru_cache(maxsize=1)
def _bluenoise_table() -> Optional[np.ndarray]:
    """The committed 128x128 rank texture (u32 offsets), or None."""
    try:
        return np.load(_BLUENOISE)
    except OSError:
        return None


def pixel_offsets(width: int, height: int, use_blue_noise: bool = True) -> np.ndarray:
    """Per-pixel LDS decorrelation offsets ([H*W] u32): the tiled
    blue-noise rank table (interleaved-gradient noise if the asset is
    missing), or a hash of the pixel id."""
    y, x = np.mgrid[0:height, 0:width]
    if use_blue_noise:
        table = _bluenoise_table()
        if table is not None:
            n = table.shape[0]
            return table[y % n, x % n].reshape(-1).copy()
        ign = np.mod(52.9829189 * np.mod(0.06711056 * x + 0.00583715 * y, 1.0), 1.0)
        return (ign * 4294967295.0).astype(np.uint32).reshape(-1)
    ids = torch.from_numpy((y * width + x).reshape(-1).astype(np.int64))
    return pcg_hash(ids).numpy().astype(np.uint32)


def resolve_device(device) -> torch.device:
    """The render device; a CUDA device must exist."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"render device {device} requested but CUDA is not available")
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported render device {device}")
    return device


def render_pixels(
    scene: SceneTensors,
    config: TracingConfig,
    px: np.ndarray,
    py: np.ndarray,
    samples: int,
    offsets: Optional[np.ndarray] = None,
    sample_start: int = 0,
    film_in: Optional[torch.Tensor] = None,
    loop: str = RenderSettings.multitile_loop,
    scan: str = RenderSettings.multitile_scan,
    single_loop: str = RenderSettings.single_tile_loop,
    engine: Optional[str] = "auto",
    backend: str = "auto",
) -> torch.Tensor:
    """Render an arbitrary pixel set on the scene's device; returns the
    film *sum* [B, 3] there. `loop` names the multi-tile loop, `scan` the
    form of its scans, `single_loop` the loop of a one-tile scene (the
    staged pipeline's arguments). `engine`: an intersection engine, or
    None for the staged pipeline (see the module docstring).
    `backend="cpu"` moves the scene and `film_in` to the CPU first and
    there resolves "auto" and "flash" to "brute" or "bvh" by triangle
    count, as the JAX package's `backend="cpu"` does; the film is then on
    the CPU. `film_in` must lie on the device the render runs on
    (ValueError otherwise)."""
    if backend not in ("auto", "cpu"):
        raise ValueError(f"backend {backend!r}: expected 'auto' or 'cpu'")
    if backend == "cpu" and scene.device.type != "cpu":
        scene = scene.to("cpu")
        film_in = None if film_in is None else film_in.cpu()
        if engine in ("auto", "flash"):
            engine = cpu_engine(scene.n_tris)
    device = scene.device
    if film_in is not None and film_in.device != device:
        raise ValueError(f"film_in is on {film_in.device}, the render on {device}: "
                         "move the film sum to the scene's device first")
    if offsets is None:
        ids = torch.from_numpy(
            (np.asarray(py, np.int64) * config.width + np.asarray(px, np.int64))
        )
        offsets_t = as_i32_bits(pcg_hash(ids)).to(device)
    else:
        offsets_t = u32_bits(offsets, device)
    return render_lanes(
        scene, config.static_part(), config.dynamic_part(device), pixel_tensor(px, device),
        pixel_tensor(py, device), offsets_t, sample_start, samples, film_in=film_in, loop=loop,
        scan=scan, single_loop=single_loop, engine=engine,
    )


def u32_bits(a: np.ndarray, device) -> torch.Tensor:
    """u32 values (pixel offsets) as the int32 bits the renderers take."""
    return torch.from_numpy(np.ascontiguousarray(a, np.uint32).view(np.int32)).to(device)


def pixel_tensor(a: np.ndarray, device) -> torch.Tensor:
    """Pixel coordinates as the int32 tensor the renderers take."""
    return torch.from_numpy(np.asarray(a, np.int32)).to(device)


def render_lanes(
    scene: SceneTensors,
    cfg: StaticConfig,
    cam: CameraParams,
    px: torch.Tensor,
    py: torch.Tensor,
    offsets: torch.Tensor,
    sample_start: int,
    samples: int,
    film_in: Optional[torch.Tensor] = None,
    loop: str = RenderSettings.multitile_loop,
    scan: str = RenderSettings.multitile_scan,
    single_loop: str = RenderSettings.single_tile_loop,
    engine: Optional[str] = "auto",
) -> torch.Tensor:
    """`render_pixels` on lanes already on the scene's device (px, py and
    offsets as int32 tensors, the camera as CameraParams): the engine's
    integrator, or the staged pipeline where `engine` is None or resolves
    to "flash" on a CUDA device -> film sum [B, 3]."""
    if engine is not None:
        resolved = _pick_engine(scene, engine)
        if resolved != "flash" or scene.device.type != "cuda":
            return accumulate_samples(
                scene, cfg, cam, px, py, offsets, int(sample_start), int(samples),
                engine=resolved, film_in=film_in, scan=scan,
            )
    return render_batch_staged(
        scene, cfg, cam, px, py, offsets, int(sample_start), int(samples),
        film_in=film_in, loop=loop, scan=scan, single_loop=single_loop,
    )


def render_image(
    scene: SceneTensors,
    config: TracingConfig,
    settings: Optional[RenderSettings] = None,
    device="cuda",
    engine: Optional[str] = None,
) -> np.ndarray:
    """Render a full frame on `device`; returns the *mean* film [H, W, 3]
    float32. Pixels go in chunks of settings.batch_pixels. `engine` as in
    `render_pixels`."""
    device = resolve_device(device)
    settings = settings or RenderSettings()
    if scene.device != device:
        scene = scene.to(device)
    w, h = config.width, config.height
    offsets = pixel_offsets(w, h, settings.use_blue_noise)
    y, x = np.mgrid[0:h, 0:w]
    px = x.reshape(-1).astype(np.int32)
    py = y.reshape(-1).astype(np.int32)

    n_px = h * w
    chunk = min(int(settings.batch_pixels), n_px)
    # pad to whole chunks so every chunk has one shape
    pad = (-n_px) % chunk
    if pad:
        px = np.pad(px, (0, pad))
        py = np.pad(py, (0, pad))
        offsets = np.pad(offsets, (0, pad))

    out = np.empty((n_px + pad, 3), np.float32)
    for lo in range(0, n_px + pad, chunk):
        hi = lo + chunk
        film = render_pixels(
            scene, config, px[lo:hi], py[lo:hi], settings.samples, offsets=offsets[lo:hi],
            loop=settings.multitile_loop, scan=settings.multitile_scan,
            single_loop=settings.single_tile_loop, engine=engine,
        )
        out[lo:hi] = film.cpu().numpy()
    return (out[:n_px] / max(settings.samples, 1)).reshape(h, w, 3)
