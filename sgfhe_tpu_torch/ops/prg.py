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

Key streams. Where a result must equal the JAX package's own draws (the
seeded bootstrap key's a-column, `prng_expand`), `key_split`,
`key_fold_in`, `random_bits32` and `randint` rebuild `jax.random`'s
Threefry streams (the partitionable layout) on int64 tensors. A key is an
int64 tensor (..., 2) holding two uint32 words, the data of a JAX key:

    split(k, num)[i]       = Threefry2x32(k; (0, i))
    fold_in(k, w)          = Threefry2x32(k; (0, w))
    random_bits32(k)[i]    = y0 ^ y1 of Threefry2x32(k; (0, i)), i the
                             flat index
    randint(k, lo, hi)[i]  = lo + (((hb % span) * mult mod 2^32
                             + lb % span) mod 2^32) % span, with k1, k2 =
                             split(k, 2), hb and lb the bits of k1 and k2,
                             span = hi - lo, mult = ((2^16 % span)^2
                             mod 2^32) % span (0 for every span > 2^16)
"""

from __future__ import annotations

import itertools
import math

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


# ---------------------------------------------------------------------------
# The JAX package's key streams (see the module docstring)
# ---------------------------------------------------------------------------


def _key_words(k: torch.Tensor, extra_dims: int):
    """The two words of keys (..., 2), each shaped (...,) + (1,) * extra_dims."""
    shape = k.shape[:-1] + (1,) * extra_dims
    return k[..., 0].reshape(shape), k[..., 1].reshape(shape)


def key_split(k: torch.Tensor, num: int) -> torch.Tensor:
    """`jax.random.split(k, num)`: keys (..., 2) -> (..., num, 2)."""
    k0, k1 = _key_words(k, 1)
    y0, y1 = threefry2x32(k0, k1, 0, torch.arange(num, device=k.device))
    return torch.stack([y0, y1], dim=-1)


def key_fold_in(k: torch.Tensor, w) -> torch.Tensor:
    """`jax.random.fold_in(k, w)` for keys (..., 2) and words w (an int or
    a tensor broadcasting against the keys' batch shape)."""
    k0, k1 = _key_words(k, 0)
    y0, y1 = threefry2x32(k0, k1, 0, torch.as_tensor(w, device=k.device) & MASK32)
    return torch.stack([y0, y1], dim=-1)


def random_bits32(k: torch.Tensor, shape, offset: int = 0) -> torch.Tensor:
    """`jax.random.bits(k, shape, uint32)` for keys (..., 2) -> (...,) +
    shape int64. `offset` starts the flat counter at that index, so a
    chunk of a larger draw equals the same slice of the one-shot draw."""
    shape = tuple(shape)
    count = math.prod(shape)
    assert offset + count <= 1 << 32, "the flat counter is one 32-bit word"
    ctr = torch.arange(offset, offset + count, device=k.device).reshape(shape)
    k0, k1 = _key_words(k, len(shape))
    y0, y1 = threefry2x32(k0, k1, 0, ctr)
    return y0 ^ y1


def randint(k: torch.Tensor, shape, lo: int, hi: int, offset: int = 0) -> torch.Tensor:
    """`jax.random.randint(k, shape, lo, hi, int32)` for one key (2,) ->
    int64 tensor `shape`; `offset` as in `random_bits32`. The products
    and sums wrap at 2^32 as the JAX package's uint32 arithmetic does."""
    assert -(1 << 31) <= lo and hi <= (1 << 31) - 1, "int32 bounds only"
    span = max(hi - lo, 1)
    mult = ((((1 << 16) % span) ** 2) & MASK32) % span
    k_hi, k_lo = key_split(k, 2).unbind(0)
    offs = random_bits32(k_lo, shape, offset) % span
    if mult:  # 0 for every span above 2^16: the high draw drops out
        hb = random_bits32(k_hi, shape, offset) % span
        offs = (((hb * mult) & MASK32) + offs) & MASK32
    return lo + offs % span
