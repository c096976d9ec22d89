"""Deterministic expansion of seed bits (counterpart of
sgfhe_tpu/utils/prng.py; reference src/utils.jl:63-68 `prng_expand`).

The JAX package expands through `jax.random`. This package defines its own
expansion on Threefry-2x32 (ops/prg.py), so its `a` polynomials differ from
the JAX package's for the same seed bits; only a wire format would need the
same stream, and the port has none yet. The expansion:

    words w_0 .. w_{n/32-1}: the seed bits packed little-endian, 32 a word
    key = (0, 0); for each word j: key = Threefry2x32(key; w_j, j)
    raw[2i], raw[2i+1] = Threefry2x32(key; i, 0x50524E47)   ("PRNG")
    out = raw & (2^factor - 1)
"""

from __future__ import annotations

import torch

from ..ops import prg

_EXPAND_DOMAIN = 0x50524E47


def prng_expand(bits: torch.Tensor, factor: int) -> torch.Tensor:
    """Expand (..., n) seed bits into (..., n) uints of `factor` bits each."""
    n = bits.shape[-1]
    assert n % 32 == 0
    dev = bits.device
    weights = torch.ones(32, dtype=torch.int64, device=dev) << torch.arange(
        32, dtype=torch.int64, device=dev
    )
    words = (bits.to(torch.int64).reshape(bits.shape[:-1] + (n // 32, 32)) * weights).sum(-1)
    k0 = torch.zeros(bits.shape[:-1] + (1,), dtype=torch.int64, device=dev)
    k1 = k0
    for j in range(n // 32):
        k0, k1 = prg.threefry2x32(k0, k1, words[..., j:j + 1], j)
    ctr = torch.arange(n // 2, dtype=torch.int64, device=dev)
    y0, y1 = prg.threefry2x32(k0, k1, ctr, _EXPAND_DOMAIN)
    raw = torch.stack([y0, y1], dim=-1).reshape(bits.shape[:-1] + (n,))
    if factor >= 32:
        return raw
    return raw & ((1 << factor) - 1)
