"""The plaintext result of each kind of request, computed from the inputs'
messages, never from the circuit or the tables the port evaluates."""

from __future__ import annotations

import numpy as np


def gates(x, y) -> list:
    """A gate bootstrap's three answers: AND, OR, XOR of bits."""
    x, y = np.asarray(x, dtype=np.int64), np.asarray(y, dtype=np.int64)
    return [x & y, x | y, x ^ y]


def add_with_carry(x, y, c, k: int) -> list:
    """A k-bit digit addition with carry: (x + y + c) mod 2^k, the carry-out."""
    t = sum(np.asarray(v, dtype=np.int64) for v in (x, y, c))
    return [t % 2**k, (t >= 2**k).astype(np.int64)]


def _value(bits) -> np.ndarray:
    """(nbits, I) bits, least significant first -> (I,) integers."""
    bits = np.asarray(bits, dtype=np.int64)
    return (bits << np.arange(bits.shape[0])[:, None]).sum(axis=0)


def ripple_adder(a_bits, b_bits) -> list:
    """a + b of two nbits-bit integers: nbits sum bits, least significant
    first, then the carry-out."""
    nbits = len(a_bits)
    t = _value(a_bits) + _value(b_bits)
    return [(t >> i) & 1 for i in range(nbits + 1)]


def comparator(a_bits, b_bits) -> list:
    """a >= b, a == b of two nbits-bit integers."""
    a, b = _value(a_bits), _value(b_bits)
    return [(a >= b).astype(np.int64), (a == b).astype(np.int64)]


CIRCUITS = {"ripple_adder": ripple_adder, "comparator": comparator}
