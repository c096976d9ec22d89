"""Scheme-1 parameters (reference: src/fhe.jl:27-99 `Params`).

A copy of sgfhe_tpu/models/params.py (pure Python), kept in this package so
that the port imports nothing of the JAX package; `Params` fields must equal
the JAX package's for every n (tests/test_torch_params_ntt.py).

Derivations mirror the reference exactly for n, r, q, t, m, Dr, Dq:

    r  = 16 n                      (power of two -> Z_r arithmetic is masking)
    q  = find_modulus(2n, r*n)     (NTT-friendly prime for length-n rings)
    t  = log2(r) - 1,  m = r / 2
    Dr = r/4,  Dq = q/4,  DQ~ = Q/8

The one deliberate redesign is the big modulus: the reference picks
a single prime Q in [1220 r^4 n^2, 1225 r^4 n^2] (src/fhe.jl:64-69) and a
gadget base B = 35 r^2 n with l=2 digits (src/fhe.jl:87, B^2 >= Q). We pick
**Q as a product of L NTT-friendly primes < 2^29 in the same interval** and
use the balanced mixed-radix gadget over those primes (l = L digits, weights
w_i = prod_{j<i} p_j). This keeps every device op in uint32 lanes — the design
the reference itself validates in scheme 2 (src/fhe2.jl:57-60, Q = B*Bp with
the decomposition base an RNS modulus). Digit bounds p_i/2 < B/2 mean the
noise analysis of eprint 2018/637 holds with margin (smaller digits -> less
noise per external product; Q >= 1220 r^4 n^2 unchanged).

`Params` is a frozen, hashable dataclass of Python ints — it is the static
argument of every jitted function, exactly the "one frozen config object"
called for in SURVEY.md §5.
"""

from __future__ import annotations

import dataclasses
import math

from ..utils import primes as pr


def _num_limbs(qmax: int, limit_bits: int = 29) -> int:
    bits = qmax.bit_length()
    return max(2, math.ceil(bits / limit_bits))


@dataclasses.dataclass(frozen=True)
class Params:
    n: int
    r: int
    q: int
    t: int
    m: int
    moduli: tuple[int, ...]  # RNS primes, product = Q
    Dr: int
    Dq: int
    # RNS factorization of q for the n >= 8192 regime where q ~ 16n^2
    # exceeds one uint32 NTT modulus (the reference reaches these sizes via
    # its UInt128 `rlwe_type` knob, src/fhe.jl:71-81; we reach them the way
    # scheme 2 does, src/fhe2.jl:57-60 — q a product of NTT-friendly
    # primes, exact switching via ops/rns.rescale_exact). Empty means q is
    # the single prime (n <= 4096, the bit-stable legacy representation).
    q_moduli: tuple[int, ...] = ()

    @classmethod
    def create(cls, n: int, num_limbs: int | None = None) -> "Params":
        """Build parameters for polynomial length n (power of two,
        64 <= n <= 16384).

        `num_limbs` overrides the RNS limb count (the analog of the
        reference's `rlwe_type` width knob, src/fhe.jl:71-81).
        """
        assert n >= 64, "n must be >= 64"
        assert n & (n - 1) == 0, "n must be a power of 2"
        # n = 16384 (r = 2^18) rides the split-halves negacyclic matmul
        # (ops/poly.py) and the K=2 rescale correction ladder (ops/rns.py).
        # n = 32768 is a PRIME-GEOMETRY boundary, not an arithmetic one:
        # Q ~ 2^116 over primes ≡ 1 (mod 2m = 2^19) forces either 5 primes
        # near 2^23 (where that residue class holds only a handful of
        # primes — the balanced product window is unsatisfiable) or 4 primes
        # pushing past the 2^29 Shoup/lazy headroom. Documented in
        # docs/manual.md "Design envelope".
        assert n <= 16384, "n > 16384 exceeds the RNS prime-geometry envelope"
        r = 16 * n
        t = r.bit_length() - 1 - 1  # log2(r) - 1
        m = r // 2
        if r * n < (1 << 29):
            # single NTT-friendly prime q >= r*n with 2n | q-1 (reference
            # src/fhe.jl:57); holds through n = 4096
            q = pr.find_modulus(2 * n, r * n)
            q_moduli = (q,)
        else:
            # q ~ 16n^2 >= 2^29: q becomes a product of NTT-friendly primes
            # < 2^28 with the same lower bound (scheme-2's design,
            # models/scheme2.py) and exact RNS modulus switching
            # window [rn, 8rn]: primes ≡ 1 mod 2n are ~2n apart, so the
            # balanced 2-prime split needs a few stride-widths of slack
            # (the reference only requires q >= rn; all noise bounds are
            # relative to Dq = q/4, so upper slack is harmless)
            cnt = max(2, -(-(r * n).bit_length() // 27))
            q_moduli = pr.find_rns_primes(
                2 * n, r * n, 8 * r * n, cnt, limit=1 << 28
            )
            q = 1
            for p in q_moduli:
                q *= p
        qmin = 1220 * r**4 * n**2
        qmax = 1225 * r**4 * n**2
        count = num_limbs if num_limbs is not None else _num_limbs(qmax)
        moduli = pr.find_rns_primes(2 * m, qmin, qmax, count)
        return cls(
            n=n, r=r, q=q, t=t, m=m, moduli=moduli, Dr=r // 4, Dq=q // 4,
            q_moduli=q_moduli,
        )

    @property
    def q_factors(self) -> tuple[int, ...]:
        """The RNS factorization of q ((q,) when q is a single prime)."""
        return self.q_moduli if self.q_moduli else (self.q,)

    @property
    def Q(self) -> int:
        prod = 1
        for p in self.moduli:
            prod *= p
        return prod

    @property
    def DQ_tilde(self) -> int:
        return self.Q // 8

    @property
    def num_limbs(self) -> int:
        return len(self.moduli)

    @property
    def num_digits(self) -> int:
        """Gadget decomposition length l (reference hardcodes 2,
        src/fhe.jl:119-122; ours equals the limb count)."""
        return len(self.moduli)

    @property
    def gadget_weights(self) -> tuple[int, ...]:
        """w_i = prod_{j<i} p_j — the generalization of (1, B)."""
        out = []
        w = 1
        for p in self.moduli:
            out.append(w)
            w *= p
        return tuple(out)

    @property
    def mask_r(self) -> int:
        return self.r - 1


def prune_error_bound(params, prune: int) -> float:
    """Worst-case post-rescale phase noise (in Z_r units) added to one
    bootstrap by approximate-gadget digit pruning (dropping the `prune`
    lowest mixed-radix digits, ops/rns.flatten(prune=...)).

    Derivation (docs/theory.md "Approximate gadget"): the kept digits
    reconstruct acc - eps with |eps|_inf <= sum_{i<prune} w_i s_i
    (s_i = (p_i-1)/2; in randomized mode the pruned digits are unmasked, so
    the same bound holds). Step k of the blind rotation then adds
    (x^{u_k} - 1) * s_k * eps_k to the accumulator — infinity norm at most
    2*|eps| (two monomial shifts, s_k in {0,1}) — and later steps only
    multiply by monomials (norm-preserving), so the rotation output carries
    at most 2*n*|eps| extra, which the exact Q->r switch scales by r/Q.

    Works for scheme-1 `Params` and scheme-2 `Params` alike (both expose n,
    r, moduli, Q; both rotations run n steps). Callers must keep this far
    inside the decision budget — the dispatchers assert < Dr/16."""
    eps = 0
    w = 1
    for p in params.moduli[:prune]:
        eps += w * ((p - 1) // 2)
        w *= p
    return 2 * params.n * eps * params.r / params.Q
