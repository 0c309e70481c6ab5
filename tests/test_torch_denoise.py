"""The port's denoiser against the JAX package's (runtime/denoise.py), on
the same seeded numpy films, rtol 1e-5 (atol 1e-7 for the values that
round to zero): the firefly clamp, the a-trous filter and `denoise`.

`jnp.median` of the 8 neighbours is the mean of the 4th and 5th values;
`torch.median` would return the 4th. The tie film below has pixels whose
clamp decision turns on that difference, and the test checks that it has.
The JAX `denoise` tries the OpenImageDenoise binding first; it is not
importable here, so both packages run the same filter.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from rustic_tpu.runtime import denoise as JD
from rustic_tpu_torch.runtime import denoise as D

torch.set_num_threads(2)

RTOL, ATOL = 1e-5, 1e-7
LUM = np.asarray([0.2126, 0.7152, 0.0722], np.float32)


def noisy_film(seed, h=16, w=32):
    """Linear radiance with fireflies: a smooth ramp, noise, and a few
    pixels 50-500x brighter."""
    rng = np.random.default_rng(seed)
    base = np.tile(np.linspace(0.05, 0.8, w, dtype=np.float32)[None, :, None], (h, 1, 3))
    film = np.abs(base + rng.normal(0, 0.1, base.shape)).astype(np.float32)
    hot = rng.integers(0, h * w, 6)
    film.reshape(-1, 3)[hot] *= rng.uniform(50, 500, (6, 1)).astype(np.float32)
    film[0, :4] = 0.0
    return film


def tie_film(seed, h=16, w=32):
    """Grey levels on a coarse grid, so the 8 neighbours' luminances tie
    often, with 2-4x spikes that sit between the two medians' caps."""
    rng = np.random.default_rng(seed)
    film = (rng.integers(1, 5, (h, w, 1)) * 0.25).repeat(3, axis=-1).astype(np.float32)
    spikes = rng.random((h, w)) < 0.3
    film[spikes] *= rng.uniform(2.0, 4.0, (int(spikes.sum()), 1)).astype(np.float32)
    return film


FILMS = {"noisy0": lambda: noisy_film(0), "noisy1": lambda: noisy_film(1, 12, 20),
         "ties": lambda: tie_film(2)}


@pytest.mark.parametrize("name", sorted(FILMS))
def test_clamp_fireflies_matches_jax(name):
    film = FILMS[name]()
    want = np.asarray(JD._clamp_fireflies(jnp.asarray(film)))
    got = D._clamp_fireflies(torch.from_numpy(film)).numpy()
    assert got.dtype == np.float32 and got.shape == film.shape
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_tie_film_separates_the_two_medians():
    """On the tie film the 'lower' median (torch.median) and the mean of the
    middle pair give a different clamp on some pixels: the case the port's
    median has to get right."""
    film = tie_film(2)
    lums = np.stack([np.roll(film, (dy, dx), axis=(0, 1)) @ LUM
                     for dy in (-1, 0, 1) for dx in (-1, 0, 1) if (dy, dx) != (0, 0)])
    srt = np.sort(lums, axis=0)
    self_l = film @ LUM
    cap_mid = (srt[3] * 0.5 + srt[4] * 0.5) * 2.0 + 1e-4
    cap_low = srt[3] * 2.0 + 1e-4
    differ = (self_l > cap_low) != (self_l > cap_mid)
    assert int(differ.sum()) >= 3
    assert int((srt[3] == srt[4]).sum()) >= 10  # and ties where both agree
    lower = torch.median(torch.from_numpy(lums), dim=0).values.numpy()
    assert np.array_equal(lower, srt[3])


@pytest.mark.parametrize("iterations", [1, 3])
@pytest.mark.parametrize("name", ["noisy0", "ties"])
def test_atrous_matches_jax(name, iterations):
    film = FILMS[name]()
    want = np.asarray(JD._atrous(jnp.asarray(film), iterations))
    got = D._atrous(torch.from_numpy(film), iterations).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("name", sorted(FILMS))
def test_denoise_matches_jax(name):
    film = FILMS[name]()
    want = np.asarray(JD.denoise(film))
    got = D.denoise(film, device="cpu")
    assert isinstance(got, np.ndarray) and got.shape == film.shape
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_denoise_reduces_noise():
    """tests/test_runtime.py's check, on the port."""
    rng = np.random.default_rng(0)
    clean = np.tile(np.linspace(0.2, 0.8, 32)[None, :, None], (32, 1, 3)).astype(np.float32)
    noisy = clean + rng.normal(0, 0.15, clean.shape).astype(np.float32)
    out = D.denoise(noisy, device="cpu")
    assert np.abs(out - clean).mean() < np.abs(noisy - clean).mean() * 0.7


def test_denoise_refuses_an_absent_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        D.denoise(noisy_film(0))
