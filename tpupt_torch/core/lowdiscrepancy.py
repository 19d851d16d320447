"""Low-discrepancy sequences as pure stateless index math.

Counterpart of src/core/lowdiscrepancy.{h,cpp} (+ sobolmatrices.cpp) and the
Halton sampler's pixel-to-index CRT math (samplers/halton.cpp:83-115). Every
function maps (sample index, dimension) -> [0,1) with no mutable state.
Indices are uint32 values held in int64 tensors (see core/rng.py); every
multiply-add that can pass 2^32 is masked so that it wraps as 32-bit
arithmetic does, and a product of two 32-bit values is split in halves so
that it never passes 2^63.

The Sobol generator matrices are regenerated on the host from the Joe-Kuo
initialisation data in sobol_joekuo.npz (a byte-for-byte copy of the JAX
package's); a sample's 32 matrix columns are XOR'd together from four byte
tables a dimension (`sobol_byte_tables`), which give the same bits as the
column-by-column sum in four gathers."""

from __future__ import annotations

import functools
import os

import numpy as np
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



def compute_radical_inverse_permutations(seed: int = 0):
    """Per-dimension random digit permutations packed into one flat table
    (lowdiscrepancy.cpp ComputeRadicalInversePermutations). Returns
    (flat_perms int32, offsets int32), numpy."""
    rng = np.random.default_rng(seed)
    flat = np.empty(sum(PRIMES), np.int32)
    offsets = np.empty(MAX_DIMS, np.int32)
    off = 0
    for i, p in enumerate(PRIMES):
        offsets[i] = off
        flat[off: off + p] = rng.permutation(p)
        off += p
    return flat, offsets


def scrambled_radical_inverse(dim: int, index, perm: torch.Tensor):
    """Permutation-scrambled radical inverse (lowdiscrepancy.h:54); `perm`
    is an integer tensor of length PRIMES[dim], its digit permutation,
    including the trailing-zero digit contribution perm[0]/(b-1) * b^-D."""
    base = PRIMES[dim]
    index = as_u32(index)
    perm = perm.to(torch.int64)
    inv_base = 1.0 / base
    rev = torch.zeros_like(index)
    inv_base_n = torch.ones(index.shape, dtype=torch.float32,
                            device=index.device)
    for _ in range(_digits_for_base(base)):
        active = index > 0
        nxt = index // base
        digit = index - nxt * base
        rev = torch.where(active, (rev * base + perm[digit]) & M32, rev)
        inv_base_n = torch.where(active, inv_base_n * inv_base, inv_base_n)
        index = nxt
    tail = inv_base_n * perm[0].to(torch.float32) / (base - 1.0)
    return (rev.to(torch.float32) * inv_base_n + tail).clamp_max(_ONE_MINUS_EPS)


# ------------------------------ Sobol -------------------------------------


def _find_primitive_polys(count: int):
    """Primitive polynomials over GF(2) in increasing degree, as (degree,
    full bitmask) pairs; entry 0 stands for the van der Corput dimension."""

    def poly_mulmod(a: int, b: int, mod: int, deg: int) -> int:
        r = 0
        while b:
            if b & 1:
                r ^= a
            b >>= 1
            a <<= 1
            if a >> deg & 1:
                a ^= mod
        return r

    def is_primitive(poly_full: int, deg: int) -> bool:
        order = (1 << deg) - 1

        def powmod(base: int, e: int) -> int:
            result, b = 1, base
            while e:
                if e & 1:
                    result = poly_mulmod(result, b, poly_full, deg)
                e >>= 1
                b = poly_mulmod(b, b, poly_full, deg)
            return result

        if powmod(2, order) != 1:  # 2 == the polynomial x
            return False
        n, fac = order, []
        d = 2
        while d * d <= n:
            if n % d == 0:
                fac.append(d)
                while n % d == 0:
                    n //= d
            d += 1
        if n > 1:
            fac.append(n)
        return all(powmod(2, order // p) != 1 for p in fac)

    polys = [(0, 0)]
    deg = 1
    while len(polys) < count:
        for low in range(1 << deg):
            full = (1 << deg) | low
            if not full & 1:  # constant term must be 1
                continue
            if is_primitive(full, deg):
                polys.append((deg, full))
                if len(polys) >= count:
                    break
        deg += 1
    return polys


@functools.lru_cache(maxsize=None)
def _joekuo_data():
    """The compact Joe & Kuo initialisation data (new-joe-kuo-6, from which
    sobolmatrices.cpp was generated) and the CMaxMinDist matrices, from
    sobol_joekuo.npz beside this module; None if the file is absent."""
    path = os.path.join(os.path.dirname(__file__), "sobol_joekuo.npz")
    if not os.path.exists(path):
        return None
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def _regen(s: int, a: int, m_init, n_bits: int = 32) -> np.ndarray:
    """The forward Joe-Kuo recurrence: (degree s, coefficients a, initial
    direction numbers m_1..m_s) -> 32 matrix columns (uint32)."""
    m = [int(x) for x in m_init]
    for k in range(s, n_bits):
        new = m[k - s] ^ (m[k - s] << s)
        for j in range(1, s):
            if (a >> (s - 1 - j)) & 1:
                new ^= m[k - j] << j
        m.append(new)
    v = np.zeros(n_bits, np.uint32)
    for k in range(n_bits):
        v[k] = np.uint32((m[k] << (31 - k)) & 0xFFFFFFFF)
    return v


@functools.lru_cache(maxsize=None)
def sobol_matrices(n_dims: int = 64, n_bits: int = 32) -> np.ndarray:
    """Sobol direction-number matrices, shape (n_dims, n_bits) uint32.
    Column j is v_j scaled so that bit 31 is the most significant output
    bit (sobolmatrices.cpp layout). Dim 0 = van der Corput. From the
    Joe-Kuo data where it covers the request; else the self-generated
    construction over primitive polynomials (deterministic seed 1234)."""
    jk = _joekuo_data()
    if jk is not None and n_bits == 32 and n_dims <= len(jk["s"]):
        mats = np.zeros((n_dims, 32), np.uint32)
        mats[0] = np.uint32(1) << np.arange(31, -1, -1, dtype=np.uint32)
        for d in range(1, n_dims):
            s = int(jk["s"][d])
            off = int(jk["m_off"][d])
            mats[d] = _regen(s, int(jk["a"][d]), jk["m"][off: off + s])
        return mats
    rng = np.random.default_rng(1234)
    polys = _find_primitive_polys(n_dims)
    mats = np.zeros((n_dims, n_bits), np.uint64)
    for d in range(n_dims):
        deg, full = polys[d]
        if d == 0:
            for j in range(n_bits):
                mats[0, j] = np.uint64(1) << np.uint64(n_bits - 1 - j)
            continue
        m = [1] + [int(rng.integers(0, 1 << j) * 2 + 1) % (1 << (j + 1))
                   for j in range(1, deg)]
        a = [(full >> (deg - 1 - k)) & 1 for k in range(deg)]
        v = list(m)
        for j in range(deg, n_bits):
            new = v[j - deg] ^ (v[j - deg] << deg)
            for k in range(1, deg):
                if a[k]:
                    new ^= v[j - k] << k
            v.append(new)
        for j in range(n_bits):
            mats[d, j] = np.uint64(v[j]) << np.uint64(n_bits - 1 - j)
    return mats.astype(np.uint32)


def sobol_byte_tables(matrices: np.ndarray) -> np.ndarray:
    """(D, 4, 256) int64 tables, T[d, k, b] = XOR of the columns
    matrices[d, 8k + j] whose bit j is set in b: the XOR of the columns that
    an index's bits select is then T[d, 0, byte 0] ^ ... ^ T[d, 3, byte 3]
    (lowdiscrepancy.h:93 MultiplyGenerator, four gathers a dimension)."""
    m = np.asarray(matrices, np.uint32).astype(np.int64)
    n_dims, n_bits = m.shape
    m = np.concatenate([m, np.zeros((n_dims, 32 - n_bits), np.int64)], 1)
    b = np.arange(256)
    sel = ((b[:, None] >> np.arange(8)[None, :]) & 1).astype(bool)  # (256,8)
    out = np.zeros((n_dims, 4, 256), np.int64)
    for k in range(4):
        cols = m[:, 8 * k: 8 * k + 8]                          # (D, 8)
        for j in range(8):
            out[:, k, :] ^= np.where(sel[None, :, j], cols[:, j:j + 1], 0)
    return out


def sobol_sample_bits(index, dim: int, tables: torch.Tensor) -> torch.Tensor:
    """The 32 bits of Sobol dimension `dim` (static) at `index`, from the
    (D, 4, 256) byte tables of `sobol_byte_tables` (as a tensor on the
    index's device): four gathers XOR'd together."""
    index = as_u32(index, tables.device)
    t = tables[dim]
    v = t[0][index & 255]
    for k in range(1, 4):
        v = v ^ t[k][(index >> (8 * k)) & 255]
    return v


def sobol_sample(index, dim: int, tables: torch.Tensor) -> torch.Tensor:
    return sobol_sample_bits(index, dim, tables).to(torch.float32) \
        * 2.3283064365386963e-10


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2^32 for uint32 x (int64 tensor) and a constant c, in
    16-bit halves of c, so that no int64 product passes 2^48."""
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & M32


def laine_karras_permutation(x, seed) -> torch.Tensor:
    """Hash-based Owen-style scramble of reversed bits (Laine-Karras 2011 /
    Burley 2020 construction, public constants)."""
    x = as_u32(x)
    x = (x + as_u32(seed, x.device)) & M32
    for c in (0x6C50B47C, 0xB82F1E52, 0xC7AFE638, 0x8D22F6E6):
        x = x ^ _mul32(x, c)
    return x


def owen_scramble_u32(x, seed) -> torch.Tensor:
    """Owen-scramble a radical-inverse bit pattern (MSB-first uint32)."""
    x = _reverse_bits32(as_u32(x))
    x = laine_karras_permutation(x, seed)
    return _reverse_bits32(x)
