"""Image-quality comparison (twin of rustic_tpu/utils/compare.py): RMSE
and MAE between films, engine against engine on one device, and an
on-disk reference film rendered once that later renders are held to.

The functions take the JAX package's arguments and one more, `device`,
the render device (`runtime/render.py` `render_image`): the card unless
the caller names the CPU. The "bvh" engine is not ported and raises.
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np

from rustic_tpu_torch.config import RenderSettings, TracingConfig


def rmse(a: np.ndarray, b: np.ndarray) -> float:
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.sqrt(np.mean((a - b) ** 2)))


def mae(a: np.ndarray, b: np.ndarray) -> float:
    return float(np.mean(np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64))))


def compare_engines(
    scene,
    config: TracingConfig,
    samples: int,
    engines=("brute", "bvh", "flash"),
    device="cuda",
) -> Dict[str, float]:
    """Pairwise RMSE between intersection engines on one device. With the
    shared deterministic sampler they agree to float tolerance, so any
    geometric disagreement shows directly."""
    from rustic_tpu_torch.runtime.render import render_image

    settings = RenderSettings(samples=samples)
    films = {e: render_image(scene, config, settings, device, engine=e) for e in engines}
    out = {}
    names = list(engines)
    for i, a in enumerate(names):
        for b in names[i + 1:]:
            out[f"{a}_vs_{b}"] = rmse(films[a], films[b])
    return out


def reference_compare(
    scene,
    config: TracingConfig,
    samples: int,
    reference_path: str,
    reference_samples: Optional[int] = None,
    save_if_missing: bool = True,
    device="cuda",
) -> Optional[Dict[str, float]]:
    """Render and compare against an on-disk reference film, rendering
    that first (at reference_samples, default 4 x samples) when it is
    missing and save_if_missing is set; else None."""
    from rustic_tpu_torch.runtime.render import render_image

    film = render_image(scene, config, RenderSettings(samples=samples), device)
    if not os.path.exists(reference_path):
        if not save_if_missing:
            return None
        ref = render_image(scene, config,
                           RenderSettings(samples=reference_samples or samples * 4), device)
        # a file object: np.save appends '.npy' to a bare path without it
        with open(reference_path, "wb") as f:
            np.save(f, ref)
    ref = np.load(reference_path)
    return {
        "rmse": rmse(film, ref),
        "mae": mae(film, ref),
        "mean": float(np.asarray(film).mean()),
        "ref_mean": float(ref.mean()),
    }
