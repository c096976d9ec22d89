"""Noise-budget instrumentation (counterpart of sgfhe_tpu/debug/noise.py).

FHE fails silently, by noise overflow, not by a crash; these functions
measure the noise of a ciphertext given the secret key (reference
examples/errors.jl:52-56, `lwe_error`). They work in numpy on host copies
of the port's tensors, as the JAX package's do on its arrays.
"""

from __future__ import annotations

import numpy as np
import torch

from ..models.scheme1 import EncryptedBit, PrivateKey


def _host(x) -> np.ndarray:
    """A tensor (on any device), array or scalar -> numpy int64."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.asarray(x).astype(np.int64)


def lwe_error(sk: PrivateKey, enc_bit: EncryptedBit, expected_bit) -> np.ndarray:
    """Signed noise of an LWE ciphertext given the secret key: the distance
    of (b - <a, s>) from expected_bit * Dr, centred into (-r/2, r/2].

    A healthy post-bootstrap ciphertext has |error| << Dr/2 (the decision
    boundary); the paper's bound is Dr/4 (reference
    examples/errors.jl:103-127)."""
    params = sk.params
    a, b = _host(enc_bit.lwe.a), _host(enc_bit.lwe.b)
    phase = (b - (a * _host(sk.key)).sum(axis=-1)) % params.r
    err = (phase - _host(expected_bit) * params.Dr) % params.r
    return np.where(err > params.r // 2, err - params.r, err)


def rlwe_error(sk: PrivateKey, ct, message) -> np.ndarray:
    """Per-coefficient signed noise of a PackedCiphertext (length n) or a
    packed Ciphertext (length m), for its first n coefficients."""
    params = sk.params
    a, b = _host(ct.rlwe.a), _host(ct.rlwe.b)
    length = a.shape[-1]
    s = np.zeros(length, dtype=np.int64)
    s[: params.n] = _host(sk.key)
    # exact negacyclic convolution s * a mod r
    conv = np.zeros(length, dtype=np.int64)
    idx = np.arange(length)
    for i in np.nonzero(s)[0]:
        k = (idx + i) % length
        sgn = np.where(idx + i >= length, -1, 1)
        np.add.at(conv, k, sgn * a[idx])
    phase = (b - conv) % params.r
    msg = np.zeros(length, dtype=np.int64)
    msg[: params.n] = _host(message)
    err = (phase - msg * params.Dr) % params.r
    return np.where(err > params.r // 2, err - params.r, err)[: params.n]


def noise_budget_report(sk: PrivateKey, enc_bit: EncryptedBit, expected_bit) -> dict:
    """Summary of an LWE batch's noise in units of the decision boundary
    Dr/2: max and mean |error|, the headroom in bits, the paper's bound
    Dr/4, and whether every error is inside the boundary."""
    err = np.abs(lwe_error(sk, enc_bit, expected_bit))
    bound = sk.params.Dr / 2
    return {
        "max_abs": int(err.max()),
        "mean_abs": float(err.mean()),
        "boundary": int(bound),
        "headroom_bits": float(np.log2(bound / max(1, err.max()))),
        "paper_bound": sk.params.Dr // 4,
        "ok": bool(err.max() < bound),
    }
