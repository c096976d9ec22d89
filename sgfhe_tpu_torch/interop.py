"""Carry keys and ciphertexts across from numpy arrays (such as the JAX
package's `np.asarray(...)` outputs) to this package's objects on a
device, and back.

Arrays come in as uint32 (or any integer type holding values < 2^32) with
the JAX package's layouts: private key (n,) bits; bootstrap key and its
Shoup companions (n, 2l, 2, L, m); public key (n,) or (Lq, n) residues;
RLWE/LWE a and b mod r; RNS residues (..., L, m). Residues become int64
tensors and the bootstrap key int32 bit patterns (ops/modmath.py).
Scheme-2 objects are made when `params` is this package's scheme-2
`Params` (see `scheme2_params`).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .models import scheme2 as s2
from .models.params import Params
from .models.scheme1 import (
    LWE, RLWE, BootstrapKey, Ciphertext, PackedCiphertext, PrivateKey, PublicKey,
    resolve_device,
)
from .ops import modmath as mm


def tensor(x, device=None) -> torch.Tensor:
    """numpy integer array of uint32 values -> int64 tensor on `device`."""
    arr = np.asarray(x).astype(np.int64) & mm.MASK32
    return torch.as_tensor(arr, device=resolve_device(device))


def bits_tensor(x, device=None) -> torch.Tensor:
    """numpy array of uint32 values -> int32 tensor of the same bit patterns
    (one uint32 copy on the host, no int64 one: keys reach GiBs)."""
    return torch.from_numpy(np.array(x, dtype=np.uint32).view(np.int32)).to(resolve_device(device))


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """Tensor of uint32 values (int64 values, or int32 bit patterns) ->
    a fresh numpy uint32 array."""
    if t.dtype == torch.int32:  # bit patterns: no int64 copy
        return t.detach().contiguous().to("cpu", copy=True).numpy().view(np.uint32)
    return (t.detach().cpu().to(torch.int64) & mm.MASK32).numpy().astype(np.uint32)


def scheme2_params(params) -> s2.Params:
    """Any object with the scheme-2 Params fields (the JAX package's) ->
    this package's scheme-2 Params."""
    return s2.Params(**{f.name: getattr(params, f.name) for f in dataclasses.fields(s2.Params)})


def _scheme2(params) -> bool:
    return isinstance(params, s2.Params)


def private_key(params, key, device=None):
    cls = s2.PrivateKey if _scheme2(params) else PrivateKey
    return cls(params, tensor(key, device))


def bootstrap_key(params, hat, hat_shoup, device=None):
    cls = s2.BootstrapKey if _scheme2(params) else BootstrapKey
    return cls(params, bits_tensor(hat, device), bits_tensor(hat_shoup, device))


def public_key(params, k0, k1, device=None):
    cls = s2.PublicKey if _scheme2(params) else PublicKey
    return cls(params, tensor(k0, device), tensor(k1, device))


def lwe(a, b, device=None) -> LWE:
    return LWE(tensor(a, device), tensor(b, device))


def wide(digits, device=None) -> list[LWE]:
    """A wide integer's digit LWEs (objects with numpy-convertible a and b,
    such as the JAX package's wideint digits) -> this package's LWEs."""
    return [lwe(np.asarray(d.a), np.asarray(d.b), device) for d in digits]


def packed_ciphertext(params: Params, a, b, device=None) -> PackedCiphertext:
    return PackedCiphertext(params, RLWE(tensor(a, device), tensor(b, device)))


def ciphertext(params: Params, a, b, device=None) -> Ciphertext:
    """A packed length-m Ciphertext (pack_encrypted_bits' output)."""
    return Ciphertext(params, RLWE(tensor(a, device), tensor(b, device)))
