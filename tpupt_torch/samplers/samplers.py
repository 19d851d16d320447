"""Stateless wavefront samplers (counterpart of src/samplers/ +
core/sampler.h): every sample dimension is a pure function
`(pixel_x, pixel_y, sample_index, dim) -> [0,1)`, so any lane can evaluate
any dimension independently of batching.

  halton — pixel-to-index CRT enumeration + affine-scrambled radical
           inverses per dim (samplers/halton.cpp)
  random — pure hash (samplers/random.cpp)

The permutation coefficients come from a numpy Generator seeded with
`seed`; there is no global random state. `dim` is a static Python int."""

from __future__ import annotations

import numpy as np

from tpupt_torch.core import lowdiscrepancy as ld
from tpupt_torch.core import rng
from tpupt_torch.core.rng import M32, as_u32

_LATER = ("sobol", "02sequence", "lowdiscrepancy", "maxmindist", "stratified")


class WavefrontSampler:
    """Build once per render on the host, then call with tensors."""

    def __init__(self, name: str, xres: int, yres: int, spp: int, seed: int = 0):
        self.name = name
        self.spp = spp
        self.seed = seed
        if name == "halton":
            self.indexer = ld.HaltonPixelIndexer(xres, yres)
            gen = np.random.default_rng(seed)
            # affine digit-permutation coefficients per dim
            self.perm_a = [int(gen.integers(1, p)) for p in ld.PRIMES]
            self.perm_c = [int(gen.integers(0, p)) for p in ld.PRIMES]
        elif name == "random":
            pass
        elif name in _LATER:
            raise NotImplementedError(
                f"sampler {name!r} is not in the PyTorch port yet "
                "(ROADMAP.md queue 1, item 5)")
        else:
            raise ValueError(f"unknown sampler {name!r}")

    # px, py: (N,) integer tensors; s: sample index, tensor or Python int.

    def camera_jitter(self, px, py, s):
        """The first two dimensions: sub-pixel offsets in [0,1)^2."""
        if self.name == "halton":
            return self.indexer.sample_dim01(self._halton_index(px, py, s))
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
        px = as_u32(px)
        return rng.uniform_float(px, as_u32(py), as_u32(s, px.device), d,
                                 self.seed)

    def _halton_index(self, px, py, s):
        off = self.indexer.offset_for_pixel(px, py)
        return (off + as_u32(s, off.device) * self.indexer.stride) & M32
