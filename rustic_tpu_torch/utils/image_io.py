"""Image output (twin of rustic_tpu/utils/image_io.py): the tonemapped
8-bit PNG of a film and its raw linear radiance.

The JAX package writes PNGs through Pillow and EXRs through imageio; the
port needs neither: PNGs go through `utils/png.py` `encode_png`, and an
EXR path gets what the JAX package writes when imageio is missing, a
.npy beside it.
"""

from __future__ import annotations

import numpy as np
import torch

from rustic_tpu_torch.config import Tonemapping
from rustic_tpu_torch.ops.tonemap import apply_tonemap
from rustic_tpu_torch.utils.hdr import write_hdr
from rustic_tpu_torch.utils.png import encode_png


def film_to_u8(film: np.ndarray, tonemap: Tonemapping = Tonemapping.NONE) -> np.ndarray:
    """Linear film [H, W, 3] -> display u8 with tonemap + gamma encode."""
    film = torch.from_numpy(np.ascontiguousarray(film, np.float32))
    mapped = apply_tonemap(film, tonemap).numpy()
    return (np.clip(mapped, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)


def save_png(path: str, film: np.ndarray, tonemap: Tonemapping = Tonemapping.NONE):
    with open(path, "wb") as f:
        f.write(encode_png(film_to_u8(film, tonemap)))


def save_hdr(path: str, film: np.ndarray):
    """Raw linear radiance: .npy, or Radiance .hdr; any other path (an
    .exr) gets a .npy beside it."""
    film = np.asarray(film, np.float32)
    if path.endswith(".npy"):
        np.save(path, film)
    elif path.endswith(".hdr"):
        write_hdr(path, film)
    else:
        np.save(path + ".npy", film)
