"""Bit packing and unpacking (counterpart of sgfhe_tpu/utils/bits.py;
reference src/utils.jl:36-54 packbits/unpackbits).

Used by the space-optimal ciphertext encodings (6 bits per message bit for
private-key encryption, 10 + log2(n) for public-key; reference
src/fhe.jl:293-301, 375-383). The bit axis is the leading axis of the bit
array, the reference's (itemsize, n) BitArray layout.
"""

from __future__ import annotations

import torch


def packbits(bits: torch.Tensor) -> torch.Tensor:
    """(itemsize, ...) {0,1} tensor -> (...) int64; row i supplies bit 2^i."""
    itemsize = bits.shape[0]
    shifts = torch.arange(itemsize, dtype=torch.int64, device=bits.device)
    weights = (torch.ones_like(shifts) << shifts).reshape((itemsize,) + (1,) * (bits.ndim - 1))
    return (bits.to(torch.int64) * weights).sum(0)


def unpackbits(arr: torch.Tensor, itemsize: int) -> torch.Tensor:
    """(...) unsigned values -> (itemsize, ...) {0,1} uint8; row i holds
    bit 2^i."""
    shifts = torch.arange(itemsize, dtype=torch.int64, device=arr.device)
    shifts = shifts.reshape((itemsize,) + (1,) * arr.ndim)
    return ((arr.to(torch.int64)[None] >> shifts) & 1).to(torch.uint8)
