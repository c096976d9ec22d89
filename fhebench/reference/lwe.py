"""LWE decryption over Z_r, the same for both schemes: a message z is
encoded as z * Dr, and an answer decrypts to the nearest multiple of Dr
(eprint 2018/637 and 2019/521: decryption of a bit and of a digit)."""

from __future__ import annotations

import numpy as np

#: Rows of a block of answers decrypted at once.
BLOCK = 8192


def phases(a: np.ndarray, b: np.ndarray, s: np.ndarray, r: int) -> np.ndarray:
    """b - <a, s> mod r of every answer; a (N, n), b (N,), s (n,) in {0, 1}."""
    a, b, s = (np.asarray(x, dtype=np.int64) for x in (a, b, s))
    out = np.empty(b.shape[0], dtype=np.int64)
    for i in range(0, b.shape[0], BLOCK):
        out[i:i + BLOCK] = (b[i:i + BLOCK] - a[i:i + BLOCK] @ s) % r
    return out


def judge(a, b, s, r: int, Dr: int, expected) -> tuple[int, int, float]:
    """(answers, wrong, sum of squared noise) of a block of answers against
    the messages they should hold: an answer is wrong when it does not
    decrypt to its message; its noise is the signed distance of its phase
    from message * Dr."""
    expected = np.asarray(expected, dtype=np.int64).reshape(-1)
    ph = phases(a, b, s, r)
    got = ((ph + Dr // 2) % r) // Dr
    noise = (ph - expected * Dr) % r
    noise = np.where(noise > r // 2, noise - r, noise).astype(np.float64)
    return int(expected.size), int((got != expected).sum()), float((noise * noise).sum())
