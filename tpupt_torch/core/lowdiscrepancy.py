"""Halton low-discrepancy sequence as pure stateless index math.

Counterpart of src/core/lowdiscrepancy.{h,cpp} and the Halton sampler's
pixel-to-index CRT math (samplers/halton.cpp:83-115). Every function maps
(sample index, dimension) -> [0,1) with no mutable state. Indices are uint32
values held in int64 tensors (see core/rng.py); every multiply-add that can
pass 2^32 is masked so that it wraps as 32-bit arithmetic does."""

from __future__ import annotations

import torch

from tpupt_torch.core.rng import M32, as_u32


def _first_primes(n: int):
    primes = []
    c = 2
    while len(primes) < n:
        if all(c % p for p in primes if p * p <= c):
            primes.append(c)
        c += 1
    return primes


MAX_DIMS = 256
PRIMES = _first_primes(MAX_DIMS)
_ONE_MINUS_EPS = 1.0 - 1e-7


def _reverse_bits32(x: torch.Tensor) -> torch.Tensor:
    """Bit reversal of a uint32 (lowdiscrepancy.h ReverseBits32)."""
    x = ((x << 16) | (x >> 16)) & M32
    x = ((x & 0x00FF00FF) << 8) | ((x & 0xFF00FF00) >> 8)
    x = ((x & 0x0F0F0F0F) << 4) | ((x & 0xF0F0F0F0) >> 4)
    x = ((x & 0x33333333) << 2) | ((x & 0xCCCCCCCC) >> 2)
    x = ((x & 0x55555555) << 1) | ((x & 0xAAAAAAAA) >> 1)
    return x


def _digits_for_base(base: int) -> int:
    """Digits of a uint32 index in the given base (static per dim)."""
    n, d = 1, 0
    while n < 2**32:
        n *= base
        d += 1
    return d


def _reversed_digits(base: int, index: torch.Tensor, a: int = 1, c: int = 0):
    """(rev, base^-k) of the k digits of `index`, each digit d sent through
    the affine permutation (a*d + c) mod base before it is appended."""
    inv_base = 1.0 / base
    rev = torch.zeros_like(index)
    inv_base_n = torch.ones(index.shape, dtype=torch.float32,
                            device=index.device)
    for _ in range(_digits_for_base(base)):
        active = index > 0
        nxt = index // base
        digit = index - nxt * base
        pdigit = (digit * a + c) % base
        rev = torch.where(active, (rev * base + pdigit) & M32, rev)
        inv_base_n = torch.where(active, inv_base_n * inv_base, inv_base_n)
        index = nxt
    return rev, inv_base_n


def radical_inverse(dim: int, index) -> torch.Tensor:
    """Radical inverse of `index` in the dim-th prime base
    (lowdiscrepancy.h:50 RadicalInverse). `dim` is static."""
    base = PRIMES[dim]
    index = as_u32(index)
    if base == 2:
        return _reverse_bits32(index).to(torch.float32) * 2.3283064365386963e-10
    rev, inv_base_n = _reversed_digits(base, index)
    return (rev.to(torch.float32) * inv_base_n).clamp_max(_ONE_MINUS_EPS)


def scrambled_radical_inverse_affine(dim: int, index, a: int, c: int):
    """Scrambled radical inverse with the AFFINE digit permutation
    perm(d) = (a*d + c) mod b (valid for prime b with 1 <= a < b): no
    permutation table to gather from."""
    base = PRIMES[dim]
    a = int(a) % base or 1
    c = int(c) % base
    rev, inv_base_n = _reversed_digits(base, as_u32(index), a, c)
    tail = inv_base_n * float(c) / (base - 1.0)
    return (rev.to(torch.float32) * inv_base_n + tail).clamp_max(_ONE_MINUS_EPS)


def inverse_radical_inverse(base: int, n_digits: int, x) -> torch.Tensor:
    """Reverse the base-b digits of x (lowdiscrepancy.h InverseRadicalInverse):
    maps a pixel coordinate to the index whose radical inverse lands on it."""
    x = as_u32(x)
    out = torch.zeros_like(x)
    for _ in range(n_digits):
        nxt = x // base
        out = (out * base + (x - nxt * base)) & M32
        x = nxt
    return out


def multiplicative_inverse(a: int, n: int) -> int:
    """a^-1 mod n via extended Euclid (halton.cpp:88 multiplicativeInverse)."""
    t, new_t, r, new_r = 0, 1, n, a % n
    while new_r != 0:
        q = r // new_r
        t, new_t = new_t, t - q * new_t
        r, new_r = new_r, r - q * new_r
    if r > 1:
        raise ValueError("not invertible")
    return t % n


K_MAX_RESOLUTION = 128


class HaltonPixelIndexer:
    """Pixel-to-global-sample-index CRT math of the reference Halton sampler
    (halton.cpp:83-115): the first two Halton dimensions enumerate pixels in
    a (2^j, 3^k) tile pattern; for a given pixel, samples are found at
    index = offset(pixel) + s * stride."""

    def __init__(self, res_x: int, res_y: int):
        j, scale_x = 0, 1
        while scale_x < min(res_x, K_MAX_RESOLUTION):
            scale_x *= 2
            j += 1
        k, scale_y = 0, 1
        while scale_y < min(res_y, K_MAX_RESOLUTION):
            scale_y *= 3
            k += 1
        self.base_exp = (j, k)
        self.base_scale = (scale_x, scale_y)
        self.stride = scale_x * scale_y
        self.mult_inv = (
            multiplicative_inverse(scale_y, scale_x) if scale_x > 1 else 0,
            multiplicative_inverse(scale_x, scale_y) if scale_y > 1 else 0,
        )

    def offset_for_pixel(self, px, py) -> torch.Tensor:
        """First global index whose first-two-dim radical inverses land in
        pixel (px, py) (halton.cpp GetIndexForSample)."""
        px, py = as_u32(px), as_u32(py)
        if self.stride == 1:
            return torch.zeros_like(px)
        d0 = inverse_radical_inverse(2, self.base_exp[0], px % K_MAX_RESOLUTION)
        d1 = inverse_radical_inverse(3, self.base_exp[1], py % K_MAX_RESOLUTION)
        m0 = (self.stride // self.base_scale[0]) * self.mult_inv[0] % self.stride
        m1 = (self.stride // self.base_scale[1]) * self.mult_inv[1] % self.stride
        off0 = (d0 * m0) & M32
        off1 = (d1 * m1) & M32
        return ((off0 + off1) & M32) % self.stride

    def sample_dim01(self, index: torch.Tensor):
        """Dims 0/1 with the pixel-digit part removed (halton.cpp
        SampleDimension): offsets within the pixel in [0,1)."""
        x = radical_inverse(0, index >> self.base_exp[0])
        x = x * self.base_scale[0]
        x = x - torch.floor(x)
        y = radical_inverse(1, index // self.base_scale[1])
        y = y * self.base_scale[1]
        y = y - torch.floor(y)
        return x, y

