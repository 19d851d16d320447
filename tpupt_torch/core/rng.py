"""Counter-based stateless RNG (counterpart of src/core/rng.h PCG32): every
random decision is a pure hash of (pixel id, sample id, dimension, seed), so
results are bit-identical whatever the batch decomposition.

PyTorch's uint32 has few operators, so the 32-bit arithmetic runs in int64
and is masked back to 32 bits after every multiply and add."""

from __future__ import annotations

import torch

M32 = 0xFFFFFFFF
_U32_TO_UNIT = 2.3283064365386963e-10  # 2^-32
_ONE_MINUS_EPS = 1.0 - 1e-7


def as_u32(x, device=None) -> torch.Tensor:
    """x (tensor or Python int) as an int64 tensor holding its value mod 2^32."""
    if not isinstance(x, torch.Tensor):
        x = torch.tensor(int(x), dtype=torch.int64, device=device)
    return x.to(torch.int64) & M32


def u32_to_unit_float(bits: torch.Tensor) -> torch.Tensor:
    """uint32 bits -> float32 in [0, 1) (rng.h UniformFloat semantics)."""
    return (bits.to(torch.float32) * _U32_TO_UNIT).clamp_max(_ONE_MINUS_EPS)


def pcg_hash(x) -> torch.Tensor:
    """PCG output permutation over an LCG step: a high-quality 32-bit hash."""
    x = as_u32(x)
    state = (x * 747796405 + 2891336453) & M32
    word = (((state >> ((state >> 28) + 4)) ^ state) * 277803737) & M32
    return (word >> 22) ^ word


def hash_combine(a, b) -> torch.Tensor:
    a = as_u32(a)
    b = as_u32(b, device=a.device)
    return pcg_hash(a ^ ((b + 0x9E3779B9 + (a << 6) + (a >> 2)) & M32))


def uniform_u32(*keys) -> torch.Tensor:
    """Hash a tuple of uint32 tensors/ints into uniform bits."""
    device = next((k.device for k in keys if isinstance(k, torch.Tensor)), None)
    h = pcg_hash(as_u32(keys[0], device))
    for k in keys[1:]:
        h = hash_combine(h, k)
    return h


def uniform_float(*keys) -> torch.Tensor:
    """Uniform [0,1) float32 from hashed keys."""
    return u32_to_unit_float(uniform_u32(*keys))
