"""Stateless wavefront samplers (counterpart of src/samplers/ +
core/sampler.h): every sample dimension is a pure function
`(pixel_x, pixel_y, sample_index, dim) -> [0,1)`, so any lane can evaluate
any dimension independently of batching.

  halton     — pixel-to-index CRT enumeration + affine-scrambled radical
               inverses per dim (samplers/halton.cpp)
  sobol      — Joe-Kuo generator matrices + per-pixel hash Owen scrambling
               (samplers/sobol.cpp analog: the scrambling replaces the
               reference's pixel-digit index offsetting)
  02sequence / lowdiscrepancy — the same Sobol dimensions with per-pixel,
               per-dimension scrambling (samplers/zerotwosequence.cpp analog)
  maxmindist — the CMaxMinDist (0,2)-sequence matrices for the pixel
               dimensions (maxmin.h), chosen by log2(spp), with an XOR
               shuffle of the sample order; higher dims scrambled Sobol
  stratified — jittered strata per (pixel, dim) (samplers/stratified.cpp)
  random     — pure hash (samplers/random.cpp)

The permutation coefficients come from a numpy Generator seeded with
`seed`; there is no global random state. `dim` is a static Python int.
Tables (Sobol byte tables) move to the device of the pixel tensors on
first use and are kept per device."""

from __future__ import annotations

import numpy as np
import torch

from tpupt_torch.core import lowdiscrepancy as ld
from tpupt_torch.core import rng
from tpupt_torch.core.rng import M32, as_u32, u32_to_unit_float

SOBOL_NAMES = ("sobol", "02sequence", "lowdiscrepancy", "maxmindist")


class WavefrontSampler:
    """Build once per render on the host, then call with tensors."""

    def __init__(self, name: str, xres: int, yres: int, spp: int, seed: int = 0):
        self.name = name
        self.spp = spp
        self.seed = seed
        self._tables = {}   # (kind, device) -> byte tables on that device
        if name == "halton":
            self.indexer = ld.HaltonPixelIndexer(xres, yres)
            gen = np.random.default_rng(seed)
            # affine digit-permutation coefficients per dim
            self.perm_a = [int(gen.integers(1, p)) for p in ld.PRIMES]
            self.perm_c = [int(gen.integers(0, p)) for p in ld.PRIMES]
        elif name in SOBOL_NAMES:
            self._host = {"sobol": ld.sobol_byte_tables(ld.sobol_matrices(64))}
            self.cpixel = None
            if name == "maxmindist":
                # published max-min-distance (0,2)-sequence generator
                # matrices (CMaxMinDist, lowdiscrepancy.cpp:249; selected by
                # log2(spp), maxmin.h:54-77): pixel dims (0,1) become
                # (i/spp, C x i); higher dims stay scrambled Sobol
                jk = ld._joekuo_data()
                if jk is not None and "cmaxmindist" in jk:
                    spp2 = 1 << max(int(np.ceil(np.log2(max(spp, 1)))), 0)
                    cidx = min(int(np.log2(spp2)),
                               jk["cmaxmindist"].shape[0] - 1)
                    self.spp_pow2 = 1 << cidx
                    self.cpixel = jk["cmaxmindist"][cidx][None, :]
                    self._host["cpixel"] = ld.sobol_byte_tables(self.cpixel)
        elif name in ("stratified", "random"):
            pass
        else:
            raise ValueError(f"unknown sampler {name!r}")

    def tables(self, kind: str, device) -> torch.Tensor:
        """The (D, 4, 256) byte tables `kind` ("sobol" or "cpixel") on
        `device`, uploaded once."""
        key = (kind, torch.device(device))
        if key not in self._tables:
            self._tables[key] = torch.from_numpy(self._host[kind]).to(device)
        return self._tables[key]

    # px, py: (N,) integer tensors; s: sample index, tensor or Python int.

    def camera_jitter(self, px, py, s):
        """The first two dimensions: sub-pixel offsets in [0,1)^2."""
        if self.name == "halton":
            return self.indexer.sample_dim01(self._halton_index(px, py, s))
        if self.name == "maxmindist" and self.cpixel is not None:
            # (i/spp, CPixel x i) with a per-pixel XOR shuffle of the sample
            # order (maxmin.cpp:44-46's Shuffle, stateless analog: an XOR
            # mask permutes [0, 2^k) and keeps the point set intact)
            px, py = as_u32(px), as_u32(py)
            mask = rng.uniform_u32(px, py, self.seed, 0x51ab) % self.spp_pow2
            i = (as_u32(s, px.device) % self.spp_pow2) ^ mask
            u1 = i.to(torch.float32) / float(self.spp_pow2)
            bits = ld.sobol_sample_bits(i, 0, self.tables("cpixel", px.device))
            return u1, u32_to_unit_float(bits)
        return self.dim(px, py, s, 0), self.dim(px, py, s, 1)

    def dim(self, px, py, s, d: int):
        """Sample dimension d (static int)."""
        if self.name == "halton":
            d = min(d, ld.MAX_DIMS - 1)
            idx = self._halton_index(px, py, s)
            if d == 0 or d == 1:
                return self.indexer.sample_dim01(idx)[d]
            return ld.scrambled_radical_inverse_affine(
                d, idx, self.perm_a[d], self.perm_c[d])
        px, py = as_u32(px), as_u32(py)
        s = as_u32(s, px.device)
        if self.name in SOBOL_NAMES:
            d = min(d, 63)
            pix_seed = rng.uniform_u32(px, py, self.seed, d)
            bits = ld.sobol_sample_bits(s, d, self.tables("sobol", px.device))
            return u32_to_unit_float(ld.owen_scramble_u32(bits, pix_seed))
        if self.name == "stratified":
            # stratify each dim over spp strata with per-pixel shuffling
            n = max(self.spp, 1)
            perm_key = rng.uniform_u32(px, py, self.seed, d)
            stratum = ((s + perm_key % n) & M32) % n
            jit = rng.uniform_float(px, py, s, d, self.seed)
            # divide by a tensor on the lanes' device: a CUDA division by a
            # Python number multiplies by its reciprocal, which differs from
            # the division in the last bit unless n is a power of two
            return (stratum.to(torch.float32) + jit) / jit.new_tensor(float(n))
        return rng.uniform_float(px, py, s, d, self.seed)

    def _halton_index(self, px, py, s):
        off = self.indexer.offset_for_pixel(px, py)
        return (off + as_u32(s, off.device) * self.indexer.stride) & M32
