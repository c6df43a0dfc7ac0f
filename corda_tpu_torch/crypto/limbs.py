"""Limb representation for batched 256-bit integers (numpy, host side).

Copy of corda_tpu/crypto/limbs.py: the port keeps the JAX package's
interface layout so both packages can be fed the same arrays.

A big integer is a vector of NLIMB radix-2^12 digits stored in int32.
A *batch* of B integers is a single `[NLIMB, B]` int32 array, batch
minor, so each limb row is a contiguous [B] vector.

22 limbs * 12 bits = 264 bits >= 256-bit field elements with slack for
Montgomery R = 2^264. (The CUDA ladder kernels convert to 8x32-bit
words internally; see csrc/wei_ladder.cu.)
"""

from __future__ import annotations

import numpy as np

LIMB_BITS = 12
LIMB_MASK = (1 << LIMB_BITS) - 1
NLIMB = 22                      # 264 bits
RADIX = 1 << LIMB_BITS
R_BITS = NLIMB * LIMB_BITS      # Montgomery R = 2**R_BITS


def int_to_limbs(x: int, nlimb: int = NLIMB) -> np.ndarray:
    """Host: python int -> [nlimb] int32 little-endian radix-2^12 digits."""
    if x < 0:
        raise ValueError("negative")
    out = np.zeros(nlimb, dtype=np.int32)
    for i in range(nlimb):
        out[i] = x & LIMB_MASK
        x >>= LIMB_BITS
    if x:
        raise ValueError(f"integer does not fit in {nlimb} limbs")
    return out


def limbs_to_int(limbs) -> int:
    """Host: [nlimb] digit array (any int dtype, possibly non-canonical) -> python int."""
    x = 0
    for i, d in enumerate(np.asarray(limbs).tolist()):
        x += int(d) << (LIMB_BITS * i)
    return x


def ints_to_batch(xs, nlimb: int = NLIMB) -> np.ndarray:
    """Host: list of B python ints -> [nlimb, B] int32 batch."""
    return np.stack([int_to_limbs(x, nlimb) for x in xs], axis=1)


def batch_to_ints(arr) -> list[int]:
    """Host: [nlimb, B] batch -> list of B python ints."""
    a = np.asarray(arr)
    return [limbs_to_int(a[:, j]) for j in range(a.shape[1])]
