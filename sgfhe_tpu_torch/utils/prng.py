"""Deterministic expansion of seed bits (counterpart of
sgfhe_tpu/utils/prng.py; reference src/utils.jl:63-68 `prng_expand`).

The same stream as the JAX package's, which folds the seed's words into
`jax.random.key(0)` and draws `jax.random.bits` from the result, rebuilt on
Threefry-2x32 (ops/prg.py), so a space-optimal ciphertext made by either
package normalizes to the same `a` in the other:

    words w_0 .. w_{n/32-1}: the seed bits packed little-endian, 32 a word
    key = (0, 0); for each word j in order: key = Threefry2x32(key; (0, w_j))
    out[i] = (y0 ^ y1 of Threefry2x32(key; (0, i))) & (2^factor - 1)
"""

from __future__ import annotations

import torch

from ..ops import prg


def prng_expand(bits: torch.Tensor, factor: int) -> torch.Tensor:
    """Expand (..., n) seed bits into (..., n) uints of `factor` bits each."""
    n = bits.shape[-1]
    assert n % 32 == 0
    dev = bits.device
    weights = torch.ones(32, dtype=torch.int64, device=dev) << torch.arange(
        32, dtype=torch.int64, device=dev
    )
    words = (bits.to(torch.int64).reshape(bits.shape[:-1] + (n // 32, 32)) * weights).sum(-1)
    key = torch.zeros(bits.shape[:-1] + (2,), dtype=torch.int64, device=dev)
    for j in range(n // 32):
        key = prg.key_fold_in(key, words[..., j])
    raw = prg.random_bits32(key, (n,))
    if factor >= 32:
        return raw
    return raw & ((1 << factor) - 1)
