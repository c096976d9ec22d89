"""Modular arithmetic on int64 tensors that hold uint32 values.

Counterpart of sgfhe_tpu/ops/modmath.py. PyTorch on the CPU has no uint32
add, shift or compare, so every plain function here computes in int64 on
values in [0, 2^32): a product of a uint32 value and a residue below 2^30
stays below 2^62, and `mulhilo` splits one operand into 16-bit halves so
that no partial product passes 2^48. Results equal the JAX package's uint32 results bit for
bit wherever those are canonical (< p).

Storage convention shared with the CUDA kernels: large tables (the
bootstrap key and its Shoup companions, the kernels' twiddle tables and the
accumulators the kernels update) are int32 tensors holding uint32 bit
patterns. `u32` widens such a tensor for the int64 code, `bits32` narrows an
int64 tensor of values < 2^32 back; the kernels read the same buffers as
`uint32_t*`.

Moduli must stay below 2^30 (asserted where plans are built).
"""

from __future__ import annotations

import torch

MASK32 = 0xFFFFFFFF


def u32(x: torch.Tensor) -> torch.Tensor:
    """int32 bit patterns (or any integer tensor) -> int64 values in [0, 2^32)."""
    return x.to(torch.int64) & MASK32


def bits32(x: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2^32) -> int32 tensor with the same bit patterns."""
    return torch.where(x >= (1 << 31), x - (1 << 32), x).to(torch.int32)


def mulhilo(a, b):
    """Exact 64-bit product of uint32 values a, b as (hi, lo) uint32 values."""
    b_lo = b & 0xFFFF
    b_hi = b >> 16
    p1 = a * b_lo  # < 2^48
    p2 = a * b_hi  # < 2^48
    mid = p1 + ((p2 & 0xFFFF) << 16)  # < 2^49
    return (p2 >> 16) + (mid >> 32), mid & MASK32


# For canonical operands (< p) a remainder equals the JAX package's
# conditional subtract, in two tensor ops instead of four.


def addmod(a, b, p):
    """(a + b) mod p for a, b < p."""
    return torch.remainder(a + b, p)


def submod(a, b, p):
    """(a - b) mod p for a, b < p."""
    return torch.remainder(a - b, p)


def negmod(a, p):
    """(-a) mod p for a < p."""
    return torch.remainder(-a, p)


def mod_u32(x, p):
    """x mod p for any uint32 x."""
    return torch.remainder(x, p)


def shoup_mul(a, w, w_shoup, p):
    """a * w mod p, canonical, for any uint32 a and w < p < 2^30: the value
    Shoup's multiply by w with w_shoup = floor(w * 2^32 / p) returns (the
    kernels compute it so), here one exact int64 product and remainder
    (a * w < 2^62) instead of an emulated multiply-high. w_shoup is unused;
    it keeps the signature of the kernels and of the JAX package."""
    return torch.remainder(a * w, p)


def mulmod(a, b, p):
    """Generic a * b mod p for a, b < 2^31 (exact in int64)."""
    return torch.remainder(a * b, p)


def embed_signed(x, p):
    """Residue of a signed integer tensor mod p (any sign, any p)."""
    return torch.remainder(x.to(torch.int64), p)


def rescale(new_max: int, x, old_max: int, round_result: bool):
    """floor or round(x * new_max / old_max) for x < old_max, rounding up at
    exactly one half, with a rounded quotient of new_max wrapping to 0: the
    reference's single-prime modulus switch (src/utils.jl:78-92), exact in
    int64 for any single modulus (the JAX package needs `rns.rescale_wide`
    past q = 2^28; here that is this same function)."""
    new_max = int(new_max)
    old_max = int(old_max)
    assert new_max * old_max < (1 << 62), "rescale: int64 range"
    prod = x * new_max
    q = torch.div(prod, old_max, rounding_mode="floor")
    r = prod - q * old_max
    if round_result:
        half = old_max // 2 + old_max % 2
        q = torch.where(r >= half, q + 1, q)
        q = torch.where(q == new_max, torch.zeros_like(q), q)
    return q


# ---------------------------------------------------------------------------
# Host-side (Python int) companions, computed once per modulus at setup time.
# ---------------------------------------------------------------------------


def shoup_const(w: int, p: int) -> int:
    """floor(w * 2^32 / p) for w < p."""
    return (int(w) << 32) // int(p)


def barrett_mu(p: int) -> int:
    """floor(2^32 / p)."""
    return (1 << 32) // int(p)
