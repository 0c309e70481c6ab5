"""Low-discrepancy sampling (R2-style LDS) and hashing, bit-equal to
rustic_tpu/ops/rng.py.

Unsigned 32-bit lane values (sample indices, per-pixel offsets) travel
through the port as int32 tensors holding the u32 bit pattern, because
torch has no uint32 arithmetic on every device. The arithmetic here
widens them to int64 and masks to 32 bits; products are split into
16-bit halves of the constant so no int64 product overflows.
"""

from __future__ import annotations

import math

import numpy as np
import torch

LDS_MAX_DIMENSIONS = 128
_M32 = 0xFFFFFFFF

# Dims 0..31: the reference's table verbatim (reference:
# kernels/src/rng.rs:21-26); it carries the original shadertoy's float
# rounding, so it differs from the exact construction in places.
_REFERENCE_PRIMES = [
    0x6A09E667, 0xBB67AE84, 0x3C6EF372, 0xA54FF539,
    0x510E527F, 0x9B05688A, 0x1F83D9AB, 0x5BE0CD18,
    0xCBBB9D5C, 0x629A2929, 0x91590159, 0x452FECD8,
    0x67332667, 0x8EB44A86, 0xDB0C2E0B, 0x47B5481D,
    0xAE5F9155, 0xCF6C85D1, 0x2F73477D, 0x6D1826CA,
    0x8B43D455, 0xE360B595, 0x1C456002, 0x6F196330,
    0xD94EBEAF, 0x9CC4A611, 0x261DC1F2, 0x5815A7BD,
    0x70B7ED67, 0xA1513C68, 0x44F93634, 0x720DCDFC,
]


def _sqrt_prime_fixed(count: int) -> list:
    """First `count` entries of floor(frac(sqrt(prime_k)) * 2^32),
    computed exactly via integer sqrt."""
    primes = []
    n = 2
    while len(primes) < count:
        if all(n % p for p in primes if p * p <= n):
            primes.append(n)
        n += 1
    return [math.isqrt(p << 64) & _M32 for p in primes]


# Dims 32+: the exactly-constructed continuation (primes 137, 139, ...).
_LDS_PRIMES = np.array(
    _REFERENCE_PRIMES + _sqrt_prime_fixed(LDS_MAX_DIMENSIONS)[32:],
    dtype=np.uint32,
)

_INV_U32 = 1.0 / 4294967296.0


def u32(x: torch.Tensor) -> torch.Tensor:
    """int32/int64 tensor -> int64 holding the u32 value of its low bits."""
    return x.to(torch.int64) & _M32


def as_i32_bits(x: torch.Tensor) -> torch.Tensor:
    """int64 tensor of u32 values -> int32 tensor with the same bits."""
    return torch.where(x >= (1 << 31), x - (1 << 32), x).to(torch.int32)


def _mul_const_u32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2^32 for int64 x in [0, 2^32) and a constant c < 2^32."""
    lo = c & 0xFFFF
    hi = c >> 16
    return (x * lo + (((x * hi) & 0xFFFF) << 16)) & _M32


def _u32_to_unit(bits: torch.Tensor) -> torch.Tensor:
    """u32 values (int64) -> f32 in [0, 1): the unsigned bits convert
    through exact 16-bit halves and one rounding add, which equals the
    round-to-nearest u32 -> f32 conversion."""
    hi = (bits >> 16).to(torch.float32)
    lo = (bits & 0xFFFF).to(torch.float32)
    return (hi * 65536.0 + lo) * _INV_U32


def lds(n: torch.Tensor, dimension: int, offset: torch.Tensor) -> torch.Tensor:
    """R2 low-discrepancy value in [0, 1): frac(prime[dim] * (n + offset))
    in u32 wraparound arithmetic (reference: kernels/src/rng.rs:29-32).
    `n` and `offset` are int32 (u32 bits) or int64 tensors."""
    prime = int(_LDS_PRIMES[dimension % LDS_MAX_DIMENSIONS])
    s = (u32(n) + u32(offset)) & _M32
    return _u32_to_unit(_mul_const_u32(s, prime))


def pcg_hash(x: torch.Tensor) -> torch.Tensor:
    """PCG output-function hash of u32 values (reference:
    kernels/src/rng.rs:4-17); returns int64 u32 values."""
    x = u32(x)
    state = (_mul_const_u32(x, 747796405) + 2891336453) & _M32
    shift = (state >> 28) + 4
    word = _mul_const_u32((state >> shift) ^ state, 277803737)
    return (word >> 22) ^ word
