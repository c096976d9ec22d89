"""Threefry-2x32 counter-based generator for the randomized-flatten masks
(counterpart of sgfhe_tpu/ops/prg.py; the CUDA kernel
csrc/rotate.cu draws the same stream).

Threefry-2x32 with 20 rounds (Salmon et al., SC'11; the Random123 default)
on int64 tensors holding uint32 words: every add is masked to 32 bits.

Stream layout for flatten masks, identical on every device and in the
kernel:

    key     = (seed_lo, seed_hi)   two uint32 words
    ctr0    = gate * m + coeff     gate = global batch index, coeff in [0, m)
    ctr1    = (step * 2 + op) * ceil(L/2) + pair
              step = blind-rotation step k, op = 0 (a) or 1 (b),
              pair = digit pair index (one block masks digits 2*pair and
              2*pair + 1)

Across calls, `fold_epoch` derives a fresh key per public call so that the
same seed words never replay a stream; within a call, `split_words`
derives disjoint keys for its stages. The JAX package folds with
`jax.random.fold_in` and splits with `jax.random.split`; this package
defines its own fold and split on the same cipher, so the internal
entries, which take the words as given, are the ones that agree with the
JAX package bit for bit.
"""

from __future__ import annotations

import itertools

import torch

MASK32 = 0xFFFFFFFF
_ROT = (13, 15, 26, 6, 17, 29, 16, 24)
_PARITY = 0x1BD11BDA

#: Rounds used for flatten masks: the Random123 standard for 2x32.
MASK_ROUNDS = 20

#: ctr1 word of `fold_epoch`: "EPOC" in ASCII, outside the mask stream's
#: (step, op, pair) range for every supported size.
_EPOCH_DOMAIN = 0x45504F43
#: ctr1 word of `split_words`: "SPLT" in ASCII.
_SPLIT_DOMAIN = 0x53504C54


def _rotl(x, r: int):
    return ((x << r) | (x >> (32 - r))) & MASK32


def threefry2x32(k0, k1, c0, c1):
    """Threefry-2x32: key (k0, k1), counter (c0, c1) -> two uint32 words.
    Arguments are Python ints or int64 tensors (broadcasting)."""
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = (c0 + ks[0]) & MASK32
    x1 = (c1 + ks[1]) & MASK32
    for i in range(MASK_ROUNDS):
        x0 = (x0 + x1) & MASK32
        x1 = _rotl(x1, _ROT[i % 8]) ^ x0
        if (i + 1) % 4 == 0:
            j = (i + 1) // 4
            x0 = (x0 + ks[j % 3]) & MASK32
            x1 = (x1 + ks[(j + 1) % 3] + j) & MASK32
    return x0, x1


_EPOCH = itertools.count()


def fold_epoch(seed_words, epoch: "int | None" = None):
    """Per-call mask key: (lo', hi') = Threefry-2x32 under key (lo, hi) of
    the counter (epoch mod 2^32, "EPOC"). epoch=None takes the next value
    of a process-wide counter, so two calls never replay a stream; an int
    pins it. Returns None for seed_words=None (deterministic mode)."""
    if seed_words is None:
        return None
    if epoch is None:
        epoch = next(_EPOCH)
    lo, hi = (int(w) & MASK32 for w in seed_words)
    return threefry2x32(lo, hi, int(epoch) & MASK32, _EPOCH_DOMAIN)


def split_words(seed2, count: int) -> list:
    """`count` seed-word pairs for disjoint mask streams within one call
    (the pack stage and its bootstraps; the rounds of a scheme-2 `mul`):
    pair i = Threefry-2x32 under key seed2 of the counter (i, "SPLT"). The
    JAX package splits its key with `jax.random.split` instead, so the
    internal entries, which take the pairs as given, are the ones that
    agree with it bit for bit."""
    lo, hi = (int(w) & MASK32 for w in seed2)
    return [threefry2x32(lo, hi, i, _SPLIT_DOMAIN) for i in range(count)]


def mask_stream_c1(step: int, op: int, pair: int, num_pairs: int) -> int:
    """The ctr1 word of the flatten-mask stream (see module docstring)."""
    return ((int(step) * 2 + op) * num_pairs + pair) & MASK32
