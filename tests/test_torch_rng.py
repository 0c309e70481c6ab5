"""The port's LDS, PCG hash and camera rays against rustic_tpu.

lds and pcg_hash must be bit-equal (integer hashing plus one exact
u32 -> f32 rounding); camera rays agree within 1e-6 (the JAX side may
fuse a multiply into an add)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from rustic_tpu.config import TracingConfig as JaxTracingConfig
from rustic_tpu.ops import rng as jax_rng
from rustic_tpu.ops.trace import camera_rays as jax_camera_rays
from rustic_tpu_torch.config import TracingConfig
from rustic_tpu_torch.ops import rng
from rustic_tpu_torch.ops.trace import camera_rays
from rustic_tpu_torch.runtime.render import pixel_offsets

torch.set_num_threads(2)

N = 100_000


def u32_draws(seed: int) -> np.ndarray:
    rng_ = np.random.default_rng(seed)
    x = rng_.integers(0, 2**32, N, dtype=np.uint32)
    x[:4] = [0, 1, 2**31, 2**32 - 1]  # the wraparound corners
    return x


def as_bits(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(x.view(np.int32))


def test_lds_table_equals_jax():
    np.testing.assert_array_equal(rng._LDS_PRIMES, jax_rng._LDS_PRIMES)


def test_lds_bit_equal_all_dims():
    n = u32_draws(1)
    off = u32_draws(2)
    dims = np.arange(rng.LDS_MAX_DIMENSIONS + 2)  # past 128 wraps
    got = torch.stack([rng.lds(as_bits(n), int(d), as_bits(off)) for d in dims]).numpy()
    want = np.stack([np.asarray(jax_rng.lds(jnp.asarray(n), int(d), jnp.asarray(off))) for d in dims])
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
    assert got.min() >= 0.0 and got.max() <= 1.0


def test_pcg_hash_bit_equal():
    x = u32_draws(3)
    got = rng.pcg_hash(as_bits(x)).numpy()
    np.testing.assert_array_equal(got.astype(np.uint32), np.asarray(jax_rng.pcg_hash(jnp.asarray(x))))
    np.testing.assert_array_equal(got.astype(np.uint32), jax_rng.pcg_hash_np(x))
    assert got.min() >= 0 and got.max() < 2**32


def test_i32_bits_round_trip():
    x = u32_draws(4)
    back = rng.as_i32_bits(rng.u32(as_bits(x)))
    assert back.dtype == torch.int32
    np.testing.assert_array_equal(back.numpy().view(np.uint32), x)


@pytest.mark.parametrize("blue", [True, False])
def test_pixel_offsets_equal_jax(blue):
    from rustic_tpu.runtime.render import pixel_offsets as jax_pixel_offsets

    np.testing.assert_array_equal(pixel_offsets(96, 40, blue), jax_pixel_offsets(96, 40, blue))


@pytest.mark.parametrize("rotation", [(0.0, 0.0), (0.15, -0.3)])
def test_camera_rays_match_jax(rotation):
    rng_ = np.random.default_rng(5)
    b = 4096
    config = TracingConfig(width=1280, height=720, cam_rotation=rotation)
    px = rng_.integers(0, 1280, b).astype(np.int32)
    py = rng_.integers(0, 720, b).astype(np.int32)
    sidx = u32_draws(6)[:b]
    off = u32_draws(7)[:b]
    ro, rd = camera_rays(
        config.static_part(), config.dynamic_part("cpu"), torch.from_numpy(px),
        torch.from_numpy(py), as_bits(sidx), as_bits(off),
    )
    jconfig = JaxTracingConfig(width=1280, height=720, cam_rotation=rotation)
    jro, jrd = jax_camera_rays(
        jconfig.static_part(), jconfig.dynamic_part(), jnp.asarray(px), jnp.asarray(py),
        jnp.asarray(sidx), jnp.asarray(off),
    )
    np.testing.assert_allclose(ro.numpy(), np.asarray(jro), rtol=0, atol=1e-6)
    np.testing.assert_allclose(rd.numpy(), np.asarray(jrd), rtol=0, atol=1e-6)
