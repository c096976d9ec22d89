"""Negacyclic NTT over primes < 2^30 (counterpart of sgfhe_tpu/ops/ntt.py).

Arrays are (..., L, m) int64 tensors of canonical residues; per-limb
constants are (L, 1) tensors that broadcast against them. The forward
transform is a ψ pre-twist followed by decimation in frequency, so its
output is in bit-reversed "hat" order: hat position idx evaluates the
polynomial at ψ^(2*br(idx)+1). The inverse is the mirrored decimation in
time followed by the ψ^{-i}·m^{-1} post-twist. The bootstrap key is stored
in this hat order, so `build_plan` takes ψ from the same deterministic
`root_of_unity` as the JAX package and every table equals its counterpart
bit for bit (tests/test_torch_params_ntt.py). A plan built with
negacyclic=False is the plain cyclic transform over x^m - 1 (ψ = 1), the
sub-transforms of the distributed four-step NTT (parallel/ntt_dist.py).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..utils import primes as pr
from . import modmath as mm


def _bit_reverse_indices(m: int) -> np.ndarray:
    bits = m.bit_length() - 1
    idx = np.arange(m)
    out = np.zeros(m, dtype=np.int64)
    for b in range(bits):
        out |= ((idx >> b) & 1) << (bits - 1 - b)
    return out


@dataclasses.dataclass(frozen=True)
class NttPlan:
    """Twiddle tables for L coprime moduli sharing length m, as int64 tensors
    on one device. `p`, `mu` are (L, 1)."""

    moduli: tuple
    p: torch.Tensor          # (L, 1)
    mu: torch.Tensor         # (L, 1) floor(2^32/p)
    fwd_tw: tuple            # per stage: ((L, half), (L, half)) value/shoup
    inv_tw: tuple            # per stage (half = 1, 2, ..., m/2)
    pre_tw: torch.Tensor     # (L, m) ψ^i
    pre_tw_s: torch.Tensor
    post_tw: torch.Tensor    # (L, m) ψ^{-i} * m^{-1}
    post_tw_s: torch.Tensor
    # mono_pow[b, li, idx] = ψ^{E[idx] * 2^b mod 2m}, E[idx] = 2*br(idx)+1
    mono_pow: torch.Tensor   # (log2(2m), L, m)
    mono_pow_s: torch.Tensor

    @property
    def num_limbs(self) -> int:
        return len(self.moduli)

    @property
    def length(self) -> int:
        return self.pre_tw.shape[-1]


def _shoup_table(vals: np.ndarray, moduli) -> np.ndarray:
    p = np.array(moduli, dtype=np.uint64).reshape((len(moduli),) + (1,) * (vals.ndim - 1))
    return (vals.astype(np.uint64) << np.uint64(32)) // p


def build_plan_host(moduli: tuple[int, ...], m: int, negacyclic: bool = True) -> dict:
    """The plan's tables as numpy uint64 arrays (exact host computation,
    the same loops as the JAX package's build_plan): the ψ-twisted
    transform over x^m + 1, or with negacyclic=False the cyclic one over
    x^m - 1 (ψ = 1, ω a primitive m-th root)."""
    assert m >= 2 and (m & (m - 1)) == 0
    L = len(moduli)
    stages = m.bit_length() - 1
    br = _bit_reverse_indices(m)
    fwd = [np.zeros((L, m >> (s + 1)), dtype=np.uint64) for s in range(stages)]
    inv = [np.zeros((L, 1 << s), dtype=np.uint64) for s in range(stages)]
    pre = np.zeros((L, m), dtype=np.uint64)
    post = np.zeros((L, m), dtype=np.uint64)
    psi_pow = np.zeros((L, 2 * m), dtype=np.uint64)
    for li, p in enumerate(moduli):
        assert p < (1 << 30), "moduli must be < 2^30 for Shoup/lazy arithmetic"
        if negacyclic:
            assert (p - 1) % (2 * m) == 0, "p must be ≡ 1 mod 2m for negacyclic NTT"
            psi = pr.root_of_unity(2 * m, p)
            assert pow(psi, m, p) == p - 1
            omega = psi * psi % p
        else:
            assert (p - 1) % m == 0, "p must be ≡ 1 mod m for cyclic NTT"
            psi = 1
            omega = pr.root_of_unity(m, p)
        inv_omega = pr.inv_mod(omega, p)
        inv_psi = pr.inv_mod(psi, p)
        inv_m = pr.inv_mod(m, p)
        for s in range(stages):
            half = m >> (s + 1)
            w = pow(omega, 1 << s, p)
            cur = 1
            for j in range(half):
                fwd[s][li, j] = cur
                cur = cur * w % p
        for s in range(stages):
            h = 1 << s
            w = pow(inv_omega, m // (2 * h), p)
            cur = 1
            for j in range(h):
                inv[s][li, j] = cur
                cur = cur * w % p
        cur = 1
        for i in range(m):
            pre[li, i] = cur
            cur = cur * psi % p
        cur = inv_m
        for i in range(m):
            post[li, i] = cur
            cur = cur * inv_psi % p
        cur = 1
        for k in range(2 * m):
            psi_pow[li, k] = cur
            cur = cur * psi % p
    nbits = (2 * m).bit_length() - 1  # exponents live in [0, 2m)
    e = 2 * br + 1
    mono = np.stack(
        [psi_pow[:, (e << b) % (2 * m)] for b in range(nbits)]
    )  # (nbits, L, m)
    return dict(fwd=fwd, inv=inv, pre=pre, post=post, psi_pow=psi_pow,
                mono=mono)


def build_plan(moduli: tuple[int, ...], m: int, device, negacyclic: bool = True) -> NttPlan:
    """Host-side plan construction (exact), tables moved to `device`."""
    moduli = tuple(int(p) for p in moduli)
    L = len(moduli)
    h = build_plan_host(moduli, m, negacyclic)

    def t(a):
        return torch.as_tensor(np.asarray(a, dtype=np.int64), device=device)

    def pair(v):
        return t(v), t(_shoup_table(v, moduli))

    return NttPlan(
        moduli=moduli,
        p=t(np.array(moduli).reshape(L, 1)),
        mu=t(np.array([mm.barrett_mu(p) for p in moduli]).reshape(L, 1)),
        fwd_tw=tuple(pair(v) for v in h["fwd"]),
        inv_tw=tuple(pair(v) for v in h["inv"]),
        pre_tw=t(h["pre"]),
        pre_tw_s=t(_shoup_table(h["pre"], moduli)),
        post_tw=t(h["post"]),
        post_tw_s=t(_shoup_table(h["post"], moduli)),
        mono_pow=t(h["mono"]),
        mono_pow_s=t(np.stack([_shoup_table(x, moduli) for x in h["mono"]])),
    )


def ntt_fwd(plan: NttPlan, x: torch.Tensor) -> torch.Tensor:
    """(..., L, m) plain coefficients -> (..., L, m) hat (bit-reversed order)."""
    p = plan.p
    m = plan.length
    x = mm.shoup_mul(x, plan.pre_tw, plan.pre_tw_s, p)
    lead = x.shape[:-1]
    k = 1
    length = m
    p3 = p[..., None]
    for w, ws in plan.fwd_tw:
        half = length // 2
        xv = x.reshape(lead + (k, length))
        u = xv[..., :half]
        v = xv[..., half:]
        tw = w.reshape(w.shape[0], 1, half)
        tws = ws.reshape(ws.shape[0], 1, half)
        e = mm.addmod(u, v, p3)
        o = mm.shoup_mul(mm.submod(u, v, p3), tw, tws, p3)
        x = torch.stack([e, o], dim=-2)
        k *= 2
        length = half
        x = x.reshape(lead + (k * length,))
    return x


def ntt_inv(plan: NttPlan, x: torch.Tensor) -> torch.Tensor:
    """(..., L, m) hat (bit-reversed) -> (..., L, m) plain coefficients."""
    p = plan.p
    m = plan.length
    lead = x.shape[:-1]
    k = m
    length = 1
    p3 = p[..., None]
    for w, ws in plan.inv_tw:
        k //= 2
        xv = x.reshape(lead + (k, 2, length))
        a = xv[..., 0, :]
        b = xv[..., 1, :]
        tw = w.reshape(w.shape[0], 1, length)
        tws = ws.reshape(ws.shape[0], 1, length)
        t = mm.shoup_mul(b, tw, tws, p3)
        x = torch.cat([mm.addmod(a, t, p3), mm.submod(a, t, p3)], dim=-1)
        length *= 2
        x = x.reshape(lead + (k * length,))
    return mm.shoup_mul(x, plan.post_tw, plan.post_tw_s, p)


def pointwise_mul(plan: NttPlan, a_hat: torch.Tensor, b_hat: torch.Tensor):
    """Generic hat-domain product."""
    return mm.mulmod(a_hat, b_hat, plan.p)


def polymul(plan: NttPlan, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Negacyclic product of (..., L, m) coefficient arrays."""
    return ntt_inv(plan, pointwise_mul(plan, ntt_fwd(plan, a), ntt_fwd(plan, b)))


def monomial_mul_hat(plan: NttPlan, x: torch.Tensor, u: torch.Tensor):
    """Multiply a hat-domain vector x (..., L, m) by the monomial x^u (u has
    x's leading batch shape), folding over u's bits with the ψ-power
    ladder, as the JAX package does."""
    nbits = plan.mono_pow.shape[0]
    cond_shape = u.shape + (1, 1)
    for b in range(nbits):
        y = mm.shoup_mul(x, plan.mono_pow[b], plan.mono_pow_s[b], plan.p)
        bit = ((u >> b) & 1).bool().reshape(cond_shape)
        x = torch.where(bit, y, x)
    return x
