"""Polynomial helpers over Z[x]/(x^m + 1) (counterpart of
sgfhe_tpu/ops/poly.py): `resize`, LWE `extract`, and the exact mod-2^k
product against a {0,1} key by NTTs over helper primes."""

from __future__ import annotations

import functools

import torch

from . import modmath as mm
from . import ntt as ntt_mod
from . import rns as rns_mod


def resize(x: torch.Tensor, m: int) -> torch.Tensor:
    """Zero-extend the coefficient axis to length m."""
    cur = x.shape[-1]
    assert m >= cur
    return torch.nn.functional.pad(x, (0, m - cur))


def extract(x: torch.Tensor, i0: int, n: int, p) -> torch.Tensor:
    """LWE coefficient extraction: out[k] = x[i0 - k] for k <= i0, else
    -x[m + i0 - k]. x: (..., m) -> (..., n)."""
    m = x.shape[-1]
    idx = torch.tensor([(i0 - k) % m for k in range(n)], device=x.device)
    neg = torch.tensor([(i0 - k) < 0 for k in range(n)], device=x.device)
    g = x[..., idx]
    return torch.where(neg, mm.negmod(g, p), g)


@functools.lru_cache(maxsize=None)
def _nega_plan(moduli: tuple[int, ...], length: int, device: torch.device):
    return ntt_mod.build_plan(moduli, length, device)


@functools.lru_cache(maxsize=None)
def _nega_rns(moduli: tuple[int, ...], device: torch.device):
    return rns_mod.build_context(moduli).device_context(device)


@functools.lru_cache(maxsize=None)
def _nega_config(
    length: int, bits: int, moduli: tuple[int, ...]
) -> tuple[int, int, int]:
    """Static plan for `negacyclic_mul_bits`: split the 2^bits operand into
    `pieces` chunks of h bits and multiply each over the first k helper
    primes. Exactness needs prod(moduli[:k]) > 2*length*2^h. Minimizes
    pieces * k."""
    best = None
    for pieces in range(1, 5):
        h = -(-bits // pieces)
        prod = 1
        for k, p in enumerate(moduli, 1):
            prod *= p
            if prod > 2 * length * (1 << h):
                cost = pieces * k
                if best is None or cost < best[0]:
                    best = (cost, pieces, h, k)
                break
    assert best is not None, (
        f"negacyclic_mul_bits: helper primes {moduli} too small for "
        f"length={length}, bits={bits}"
    )
    return best[1], best[2], best[3]


def negacyclic_mul_bits(
    a: torch.Tensor, s_bits: torch.Tensor, mask: int, moduli: tuple[int, ...]
) -> torch.Tensor:
    """Exact negacyclic product a(x) * s(x) mod (x^len + 1, 2^k) for a bit
    polynomial s in {0,1}^len, by NTTs over the helper primes `moduli`
    (2*len | p-1). a: (..., len) values <= mask (mask+1 a power of two)."""
    length = a.shape[-1]
    assert s_bits.shape == (length,)
    bits = int(mask + 1).bit_length() - 1
    moduli = tuple(int(p) for p in moduli)
    pieces, h, kp = _nega_config(length, bits, moduli)
    use = moduli[:kp]
    q = 1
    for p in use:
        q *= p
    plan = _nega_plan(use, length, a.device)

    ap = torch.stack([(a >> (i * h)) & ((1 << h) - 1) for i in range(pieces)])
    ap = ap[..., None, :].expand((pieces,) + a.shape[:-1] + (kp, length))
    sb = s_bits.to(torch.int64).expand(kp, length)
    prod = ntt_mod.polymul(plan, ap, sb)  # (pieces, ..., kp, len) residues

    # exact signed lift from the mixed-radix digits
    digits = rns_mod.mixed_radix_digits(_nega_rns(use, a.device), prod)
    nl = q.bit_length() // 32 + 1
    acc = None
    w = 1
    for i, d in enumerate(digits):
        t = rns_mod._mll_mul_const(d, w, nl)
        acc = t if acc is None else rns_mod._mll_add(acc, t)
        w *= use[i]
    ge = rns_mod._mll_ge_const(acc, (q + 1) // 2)
    c = (acc[0] - ge.to(torch.int64) * (q & mm.MASK32)) & mm.MASK32

    out = c[0]
    for i in range(1, pieces):
        out = out + (c[i] << (i * h))
    return out & mask
