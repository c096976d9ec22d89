"""Exact host-side golden model of scheme 1 (conformance oracle); the
port's own copy of sgfhe_tpu/refimpl/golden.py, on the port's `Params`.

Re-derives the reference semantics (src/fhe.jl) with Python big ints and
numpy-uint64 arithmetic, sharing NOTHING with the device path except the
`Params` object: polynomial products are exact split-matmul negacyclic
convolutions (no NTT, no Shoup), the gadget decomposition works on the
POSITIONAL value via big-int divmod (like the reference's flatten,
src/utils.jl:155-189), and rescales are exact big-int rounding.

Used by tests to check the port's bootstrap bit for bit (the Q -> r switch
is exact, ops/rns.rescale_exact), and held equal to the JAX package's copy
(tests/test_torch_golden.py). Never imported by production code paths.
"""

from __future__ import annotations

import numpy as np

from ..models.params import Params


def negacyclic_mul_u64(a: np.ndarray, b: np.ndarray, p: int) -> np.ndarray:
    """Exact negacyclic product mod p (< 2^30) of uint64 coefficient vectors.

    Splits b into 15-bit halves so every int64 accumulation stays exact:
    |a| < 2^30, |b_half| < 2^15, m <= 2^13 -> sums < 2^58.
    """
    m = len(a)
    a = np.asarray(a, dtype=np.uint64) % np.uint64(p)
    b = np.asarray(b, dtype=np.uint64) % np.uint64(p)
    # negacyclic matrix of b: M[i, k] = sign * b_{(k - i) mod m}
    idx = (np.arange(m)[None, :] - np.arange(m)[:, None]) % m
    sign_neg = (np.arange(m)[None, :] < np.arange(m)[:, None])
    bm = b[idx]
    bm = np.where(sign_neg, (np.uint64(p) - bm) % np.uint64(p), bm)
    b_lo = bm & np.uint64(0x7FFF)
    b_hi = bm >> np.uint64(15)
    lo = (a @ b_lo) % np.uint64(p)
    hi = (a @ b_hi) % np.uint64(p)
    return (lo + hi * ((1 << 15) % p)) % np.uint64(p)


class GoldenScheme:
    """Exact mirror of the scheme over Params (see module docstring)."""

    def __init__(self, params: Params):
        self.p = params
        self.Q = params.Q
        self.weights = params.gadget_weights
        self.s_off = [(q - 1) // 2 for q in params.moduli]
        self.offset = sum(w * s for w, s in zip(self.weights, self.s_off)) % self.Q

    # -- RNS <-> int helpers (CRT with big ints) --

    def to_rns(self, vals) -> np.ndarray:
        out = np.empty((len(self.p.moduli), len(vals)), dtype=np.uint64)
        for i, q in enumerate(self.p.moduli):
            out[i] = np.array([int(v) % q for v in vals], dtype=np.uint64)
        return out

    def from_rns(self, res: np.ndarray) -> list[int]:
        vals = [0] * res.shape[1]
        for i, q in enumerate(self.p.moduli):
            qi = self.Q // q
            ci = pow(qi, -1, q)
            for j in range(res.shape[1]):
                vals[j] += int(res[i, j]) * qi * ci
        return [v % self.Q for v in vals]

    def polymul_Q(self, a_res: np.ndarray, b_res: np.ndarray) -> np.ndarray:
        return np.stack(
            [
                negacyclic_mul_u64(a_res[i], b_res[i], q)
                for i, q in enumerate(self.p.moduli)
            ]
        )

    # -- gadget decomposition: positional big-int divmod (reference flatten) --

    def flatten(self, x_int: list[int]) -> list[list[int]]:
        """Balanced mixed-radix digits of each value; returns l lists of
        signed ints with |d_i| <= (p_i - 1)/2, sum_i d_i w_i ≡ x (mod Q)."""
        L = len(self.p.moduli)
        digits = [[] for _ in range(L)]
        for v in x_int:
            y = (int(v) + self.offset) % self.Q
            for i, q in enumerate(self.p.moduli):
                d = y % q
                y //= q
                digits[i].append(d - self.s_off[i])
        return digits

    def external_product(self, a_int, b_int, A_res):
        """(a, b) ⊙ A (reference src/fhe.jl:519-530): flatten both, multiply
        by the 2l x 2 matrix of polynomials A_res (RNS residues, shape
        (2l, 2, L, m)), return new (a, b) as big-int lists."""
        m = len(a_int)
        da = self.flatten(a_int)
        db = self.flatten(b_int)
        rows = da + db  # 2l digit polynomials (signed ints)
        acc = [np.zeros((len(self.p.moduli), m), dtype=np.uint64) for _ in range(2)]
        for r_idx, drow in enumerate(rows):
            d_res = self.to_rns(drow)
            for c in range(2):
                prod = self.polymul_Q(d_res, A_res[r_idx, c])
                for i, q in enumerate(self.p.moduli):
                    acc[c][i] = (acc[c][i] + prod[i]) % np.uint64(q)
        return self.from_rns(acc[0]), self.from_rns(acc[1])

    # -- bootstrap (reference src/fhe.jl:559-595) --

    def initial_poly_times_dq(self) -> list[int]:
        pmod = self.p
        DQt = pmod.DQ_tilde
        coeffs = [0] * pmod.m
        for j in range(-(pmod.Dr - 1), pmod.Dr):
            if j >= 0:
                coeffs[j] = (coeffs[j] + DQt) % self.Q
            else:
                coeffs[pmod.m + j] = (coeffs[pmod.m + j] - DQt) % self.Q
        return coeffs

    def mul_by_monomial(self, coeffs: list[int], j: int) -> list[int]:
        """coeffs * x^j with negacyclic wrap (x^m = -1)."""
        m = len(coeffs)
        j = j % (2 * m)
        out = [0] * m
        for i, c in enumerate(coeffs):
            k = (i + j) % (2 * m)
            if k < m:
                out[k] = int(c) % self.Q
            else:
                out[k - m] = (-int(c)) % self.Q
        return out

    def bootstrap_internal(self, bkey_res: np.ndarray, a1, b1, a2, b2):
        """bkey_res: (n, 2l, 2, L, m) uint64 residues (coefficient domain).
        LWE inputs mod r. Returns (and, or, xor) LWEs over Q (big ints)."""
        pmod = self.p
        mask = pmod.r - 1
        ua = [(int(x) + int(y)) & mask for x, y in zip(a1, a2)]
        ub = (int(b1) + int(b2)) & mask

        b = self.mul_by_monomial(self.initial_poly_times_dq(), -ub)
        a = [0] * pmod.m

        # A = (x^{u_k} - 1) C_k + G applied via external product
        for k in range(pmod.n):
            u = ua[k]
            A = np.empty_like(bkey_res[k])
            for row in range(A.shape[0]):
                for c in range(2):
                    cc = self.from_rns(bkey_res[k, row, c])
                    rot = self.mul_by_monomial(cc, u)
                    diff = [(x - y) % self.Q for x, y in zip(rot, cc)]
                    A[row, c] = self.to_rns(diff)
            # + G: G[i, 0] = w_i for i < l; G[l + i, 1] = w_i
            l = pmod.num_digits
            for i in range(l):
                for limb, q in enumerate(pmod.moduli):
                    wv = self.weights[i] % q
                    A[i, 0, limb, 0] = (int(A[i, 0, limb, 0]) + wv) % q
                    A[l + i, 1, limb, 0] = (int(A[l + i, 1, limb, 0]) + wv) % q
            a, b = self.external_product(a, b, A)

        def extract(coeffs, i0, n):
            out = []
            for k in range(n):
                src = i0 - k
                if src >= 0:
                    out.append(int(coeffs[src]))
                else:
                    out.append((-int(coeffs[pmod.m + src])) % self.Q)
            return out

        DQt = pmod.DQ_tilde
        i_and = 3 * pmod.m // 4
        i_or = pmod.m // 4
        lwe_and = (extract(a, i_and, pmod.n), (DQt + int(b[i_and])) % self.Q)
        lwe_or = (
            [(-x) % self.Q for x in extract(a, i_or, pmod.n)],
            (DQt - int(b[i_or])) % self.Q,
        )
        lwe_xor = (
            [(x - y) % self.Q for x, y in zip(lwe_or[0], lwe_and[0])],
            (lwe_or[1] - lwe_and[1]) % self.Q,
        )
        return lwe_and, lwe_or, lwe_xor

    def reduce_lwe_to_r(self, lwe):
        """Exact round(x * r / Q) per component (reference reduce_modulus)."""
        a, b = lwe
        r = self.p.r

        def rs(x):
            return ((int(x) * r + self.Q // 2) // self.Q) % r

        return [rs(x) for x in a], rs(b)

    def decrypt_lwe(self, s_bits, lwe_a, lwe_b) -> int:
        pmod = self.p
        mask = pmod.r - 1
        acc = 0
        for ai, si in zip(lwe_a, s_bits):
            acc += int(ai) * int(si)
        b1 = (int(lwe_b) - acc) & mask
        return ((b1 + pmod.Dr // 2) & mask) // pmod.Dr
