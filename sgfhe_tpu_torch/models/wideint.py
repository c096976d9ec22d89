"""Encrypted wide-integer arithmetic over scheme-2 digits (counterpart of
sgfhe_tpu/models/wideint.py; eprint 2019/521 §1).

Numbers are little-endian lists of W digit ciphertexts, each a (B, n) LWE
batch of B independent integers. Every op composes the functional
bootstrap of models/bootstrap2.py, so each rotation runs through the CUDA
rotation kernels on the card and through their plain versions on the CPU:

 - `add_wide`: ripple carry, W rotations, W + 1 digits out;
 - `mul_wide`: all W² digit products in one batched `mul` (3 rotation
   rounds whatever W), then column sums by pairwise `add_with_carry`;
 - `sub_wide`, `ge_wide`, `eq_wide`: two's complement over base-2^k digits;
 - `select_wide`, `min_max_wide`: a branchless mux in one rotation pass;
 - `sort_wide`: a Batcher odd-even merge network of `min_max_wide`.
Every output digit is a refreshed ciphertext, so results chain.

Randomized mode: each public op folds a fresh epoch into its two seed
words (ops/prg.fold_epoch) and splits the folded words into one pair per
rotation it runs (ops/prg.split_words). The internal forms (`_add_wide`,
`_mul_wide`, ...) take those pairs as given, a list in the order the
rotations run (`mul`'s three rounds count as three), and agree with the
JAX package bit for bit on its words. The JAX package's mux pass takes
its caller's key without folding an epoch, so two of its `select_wide` or
`min_max_wide` calls with one key replay one mask stream; here the public
ops fold an epoch like every other entry, and the internal `_mux_pass`
takes its words as given.
"""

from __future__ import annotations

import itertools

import numpy as np
import torch

from ..ops import prg
from . import bootstrap2 as bs2
from . import scheme2 as s2
from .scheme1 import LWE
from .scheme2 import BootstrapKey, Params, PrivateKey, Scheme2Context


def _iter(seeds):
    """The seed-word pairs of an op's rotations in the order they run;
    None for each in deterministic mode (seeds None)."""
    return itertools.repeat(None) if seeds is None else iter(seeds)


def _split(seed_words, epoch, count: int) -> list:
    """A public op's `count` seed-word pairs: a fresh epoch folded into
    seed_words, then split (None each in deterministic mode)."""
    seed2 = prg.fold_epoch(seed_words, epoch)
    return [None] * count if seed2 is None else prg.split_words(seed2, count)


# ---------------------------------------------------------------------------
# Encryption
# ---------------------------------------------------------------------------


def encrypt_wide(sk: PrivateKey, generator: torch.Generator, values, width: int) -> list[LWE]:
    """Encrypt B integers in [0, 2^(k*width)) as `width` base-2^k digit
    ciphertext batches. values: (B,) ints; B <= n."""
    params = sk.params
    k = params.k
    values = np.asarray(values, dtype=np.int64)
    B = values.shape[0]
    assert B <= params.n
    assert (values >= 0).all() and (values < 2 ** (k * width)).all()
    digits = []
    for j in range(width):
        msg = np.zeros(params.n, dtype=np.int64)
        msg[:B] = (values >> (k * j)) & (2**k - 1)
        lw = bs2.split_ciphertext(params, *s2.encrypt(sk, generator, torch.as_tensor(msg)))
        digits.append(LWE(lw.a[:B], lw.b[:B]))
    return digits


def decrypt_wide(sk: PrivateKey, digits: list[LWE]) -> np.ndarray:
    """Decrypt a digit-vector ciphertext back to (B,) numpy int64."""
    k = sk.params.k
    out = 0
    for j, d in enumerate(digits):
        out = out + (bs2.decrypt_lwe(sk, d).cpu().numpy().astype(np.int64) << (k * j))
    return out


def _zero_like(lwe: LWE) -> LWE:
    """Trivial (noiseless, keyless) encryption of 0."""
    return LWE(torch.zeros_like(lwe.a), torch.zeros_like(lwe.b))


# ---------------------------------------------------------------------------
# Addition and multiplication
# ---------------------------------------------------------------------------


def _add_wide(params, ctx, bkey, xs, ys, seeds, prune: int = 0):
    """`add_wide` with its W rotations' seed words given."""
    W = len(xs)
    assert len(ys) == W
    it = _iter(seeds)
    carry = None
    out = []
    for j in range(W):
        d, carry = bs2._add_with_carry(params, ctx, bkey, xs[j], ys[j], carry, next(it), prune)
        out.append(d)
    out.append(carry)
    return out


def add_wide(params: Params, ctx: Scheme2Context, bkey: BootstrapKey, xs: list[LWE],
             ys: list[LWE], seed_words=None, epoch: "int | None" = None,
             prune: int = 0) -> list[LWE]:
    """Ripple-carry addition of two W-digit numbers -> W + 1 digits (the
    last is the carry-out bit). W rotations, each batched over B."""
    return _add_wide(params, ctx, bkey, xs, ys, _split(seed_words, epoch, len(xs)), prune)


def _mul_wide_adds(W: int) -> int:
    """The add_with_carry calls of `mul_wide`'s column reduction."""
    lens = [0] * (2 * W + 1)
    for i in range(W):
        for j in range(W):
            lens[i + j] += 1
            lens[i + j + 1] += 1
    adds = 0
    for c in range(2 * W):
        extra = max(lens[c] - 1, 0)
        adds += extra
        lens[c + 1] += extra
    return adds


def _mul_wide(params, ctx, bkey, xs, ys, seeds, prune: int = 0):
    """`mul_wide` with its rotations' seed words given: three for the
    digit products' `mul` rounds, then one per column addition."""
    W = len(xs)
    assert len(ys) == W
    B = xs[0].a.shape[0]
    it = _iter(seeds)
    # one batched mul over all (i, j) digit pairs: lanes (i*W + j)-major
    l1 = LWE(torch.cat([xs[i].a for i in range(W) for _ in range(W)]),
             torch.cat([xs[i].b for i in range(W) for _ in range(W)]))
    l2 = LWE(torch.cat([ys[j].a for _ in range(W) for j in range(W)]),
             torch.cat([ys[j].b for _ in range(W) for j in range(W)]))
    lo, hi = bs2._mul(params, ctx, bkey, l1, l2, (next(it), next(it), next(it)), prune)

    cols: list[list[LWE]] = [[] for _ in range(2 * W + 1)]
    for i in range(W):
        for j in range(W):
            s = slice((i * W + j) * B, (i * W + j + 1) * B)
            cols[i + j].append(LWE(lo.a[s], lo.b[s]))
            cols[i + j + 1].append(LWE(hi.a[s], hi.b[s]))

    out = []
    for c in range(2 * W):
        pend = cols[c]
        while len(pend) > 1:
            a = pend.pop()
            b = pend.pop()
            d, carry = bs2._add_with_carry(params, ctx, bkey, a, b, None, next(it), prune)
            pend.append(d)
            cols[c + 1].append(carry)
        out.append(pend[0] if pend else _zero_like(out[0]))
    return out


def mul_wide(params: Params, ctx: Scheme2Context, bkey: BootstrapKey, xs: list[LWE],
             ys: list[LWE], seed_words=None, epoch: "int | None" = None,
             prune: int = 0) -> list[LWE]:
    """Schoolbook multiplication of two W-digit numbers -> 2W digits.

    All W² digit products run as one batched quarter-squares `mul` (3
    rotation rounds); the partial-product columns then reduce by pairwise
    add_with_carry, feeding carries into the next column. The carry out of
    column 2W-1 is zero ((2^{kW}-1)² < 2^{2kW}) and is dropped."""
    seeds = _split(seed_words, epoch, 3 + _mul_wide_adds(len(xs)))
    return _mul_wide(params, ctx, bkey, xs, ys, seeds, prune)


# ---------------------------------------------------------------------------
# Subtraction and comparison (two's complement over base-2^k digits)
# ---------------------------------------------------------------------------


def _trivial_const(params: Params, batch_shape, value: int, device) -> LWE:
    """Noiseless trivial encryption of a constant digit: a = 0,
    b = value*Dr mod r (the scheme-2 analog of the trivial LWE(0, Dr) in
    pack_encrypted_bits, reference src/fhe.jl:670-671)."""
    b = torch.full(tuple(batch_shape), (value * params.Dr) % params.r, dtype=torch.int64,
                   device=device)
    return LWE(torch.zeros(tuple(batch_shape) + (params.n,), dtype=torch.int64, device=device), b)


def complement_digit(params: Params, lwe: LWE) -> LWE:
    """(2^k - 1) - d, linear (negate mod r and add a constant; no
    bootstrap, noise magnitude unchanged)."""
    c = ((2**params.k - 1) * params.Dr) & params.mask_r
    return LWE((-lwe.a) & params.mask_r, (c - lwe.b) & params.mask_r)


def flag_not(params: Params, lwe: LWE) -> LWE:
    """1 - f for a 0/1 flag digit, linear (no bootstrap)."""
    return LWE((-lwe.a) & params.mask_r, (params.Dr - lwe.b) & params.mask_r)


def _sub_wide(params, ctx, bkey, xs, ys, seeds, prune: int = 0):
    """`sub_wide` with its W rotations' seed words given."""
    W = len(xs)
    assert len(ys) == W
    it = _iter(seeds)
    carry = _trivial_const(params, xs[0].b.shape, 1, xs[0].b.device)
    out = []
    for j in range(W):
        d, carry = bs2._add_with_carry(params, ctx, bkey, xs[j], complement_digit(params, ys[j]),
                                       carry, next(it), prune)
        out.append(d)
    return out, carry


def sub_wide(params: Params, ctx: Scheme2Context, bkey: BootstrapKey, xs: list[LWE],
             ys: list[LWE], seed_words=None, epoch: "int | None" = None,
             prune: int = 0) -> tuple[list[LWE], LWE]:
    """Two's-complement subtraction x - y = x + comp(y) + 1 digit-wise.

    Returns (diff, ge): diff = (x - y) mod 2^{kW} as W refreshed digits and
    ge = the final carry, an encrypted [x >= y] flag (carry-out == no
    borrow). W rotations, each batched over B; digit sums stay in
    [0, 2^{k+1}), the domain add_with_carry evaluates over."""
    return _sub_wide(params, ctx, bkey, xs, ys, _split(seed_words, epoch, len(xs)), prune)


def ge_wide(params: Params, ctx: Scheme2Context, bkey: BootstrapKey, xs: list[LWE],
            ys: list[LWE], seed_words=None, epoch: "int | None" = None, prune: int = 0) -> LWE:
    """Encrypted [x >= y] flag (W rotations; the diff digits are
    discarded)."""
    return sub_wide(params, ctx, bkey, xs, ys, seed_words, epoch, prune)[1]


def _flag_and(params, ctx, bkey, f1, f2, seed2, prune: int = 0):
    """`flag_and` with its rotation's seed words given."""
    zmax = 2 ** (params.k + 1)
    th = bs2.tables_hat(params, ctx, [[1 if z >= 2 else 0 for z in range(zmax)]])
    out = bs2.bootstrap_internal(params, ctx, bkey.hat, bkey.hat_shoup,
                                 bs2._lwe_sum(params, f1, f2), th, seed2, prune)
    return LWE(out.a[:, 0], out.b[:, 0])


def flag_and(params: Params, ctx: Scheme2Context, bkey: BootstrapKey, f1: LWE, f2: LWE,
             seed_words=None, epoch: "int | None" = None, prune: int = 0) -> LWE:
    """AND of two 0/1 flag digits in one rotation: the table [f1 + f2 >= 2]
    over the combined domain (every k, k = 1 included)."""
    return _flag_and(params, ctx, bkey, f1, f2, _split(seed_words, epoch, 1)[0], prune)


def _scale_flag(params: Params, flag: LWE) -> LWE:
    """2^k * flag (linear). Scales the flag's phase noise by 2^k, so the
    flag must be a refreshed ciphertext (a bootstrap output such as
    `ge_wide`'s carry, or a trivial constant): the mux phase noise is
    2^k*w_flag + w_digit, inside the Dr/2 decision boundary for
    post-bootstrap noise but not for arbitrarily noisy flags."""
    K = 2**params.k
    return LWE((flag.a * K) & params.mask_r, (flag.b * K) & params.mask_r)


def _mux_pass(params, ctx, bkey, flag, pairs, seed2, prune: int = 0) -> list[list[LWE]]:
    """The mux engine, its rotation's seed words used as given: for each
    (xs, ys) pair and each digit j, flag ? xs[j] : ys[j]. All selections
    ride one batched rotation, 2 lanes per (pair, digit): lane A has phase
    2^k*f + x_j with table T_keep(z) = z - 2^k for z >= 2^k else 0 (-> f*x_j),
    lane B has phase 2^k*f + y_j with T_drop(z) = z for z < 2^k else 0
    (-> (1-f)*y_j); the digit is the sum of the two refreshed outputs
    (noise twice a fresh bootstrap output's, still chainable)."""
    K = 2**params.k
    zmax = 2 * K
    sf = _scale_flag(params, flag)
    t_keep = [z - K if z >= K else 0 for z in range(zmax)]
    t_drop = [0 if z >= K else z for z in range(zmax)]
    th = bs2.tables_hat(params, ctx, [t_keep, t_drop])

    lanes_a, lanes_b, t_idx = [], [], []
    for xs, ys in pairs:
        assert len(xs) == len(ys)
        for xj, yj in zip(xs, ys):
            ua = bs2._lwe_sum(params, sf, xj)
            ub = bs2._lwe_sum(params, sf, yj)
            lanes_a.extend([ua.a, ub.a])
            lanes_b.extend([ua.b, ub.b])
            t_idx.extend([0, 1])
    B = pairs[0][0][0].a.shape[0]
    # each (pair, digit, table) lane is B consecutive rows
    t0 = th[torch.tensor(t_idx, device=th.device)].repeat_interleave(B, dim=0)
    out = bs2._rotate_extract(params, ctx, bkey.hat, bkey.hat_shoup, torch.cat(lanes_a),
                              torch.cat(lanes_b), t0, seed2, prune)
    results, lane = [], 0
    for xs, _ in pairs:
        sel = []
        for _ in xs:
            fa = LWE(out.a[lane * B:(lane + 1) * B], out.b[lane * B:(lane + 1) * B])
            fb = LWE(out.a[(lane + 1) * B:(lane + 2) * B], out.b[(lane + 1) * B:(lane + 2) * B])
            sel.append(bs2._lwe_sum(params, fa, fb))
            lane += 2
        results.append(sel)
    return results


def select_wide(params: Params, ctx: Scheme2Context, bkey: BootstrapKey, flag: LWE,
                xs: list[LWE], ys: list[LWE], seed_words=None, epoch: "int | None" = None,
                prune: int = 0) -> list[LWE]:
    """Encrypted branchless select: flag ? x : y digit-wise, where `flag` is
    a refreshed 0/1 flag ciphertext (a `ge_wide` or `eq_wide` output). One
    rotation pass of 2W lanes; the data path never learns which branch was
    taken."""
    return _mux_pass(params, ctx, bkey, flag, [(xs, ys)], _split(seed_words, epoch, 1)[0],
                     prune)[0]


def _min_max_wide(params, ctx, bkey, xs, ys, seeds, prune: int = 0):
    """`min_max_wide` with its W + 1 rotations' seed words given: W for
    the comparison, then the mux pass's."""
    W = len(xs)
    it = _iter(seeds)
    _, ge = _sub_wide(params, ctx, bkey, xs, ys, [next(it) for _ in range(W)], prune)
    mins, maxs = _mux_pass(params, ctx, bkey, ge, [(ys, xs), (xs, ys)], next(it), prune)
    return mins, maxs


def min_max_wide(params: Params, ctx: Scheme2Context, bkey: BootstrapKey, xs: list[LWE],
                 ys: list[LWE], seed_words=None, epoch: "int | None" = None,
                 prune: int = 0) -> tuple[list[LWE], list[LWE]]:
    """Encrypted (min, max) of two W-digit numbers: one `ge_wide`
    comparison (W rotations) and one shared mux pass of 4W lanes (both
    selections reuse the flag). W + 1 rotation passes."""
    return _min_max_wide(params, ctx, bkey, xs, ys, _split(seed_words, epoch, len(xs) + 1), prune)


def _oddeven_pairs(N: int) -> list[tuple[int, int]]:
    """Comparator pairs of Batcher's odd-even mergesort network for N a
    power of two (N=4 -> 5 comparators, depth 3)."""
    assert N >= 2 and N & (N - 1) == 0
    pairs = []
    p = 1
    while p < N:
        k = p
        while k >= 1:
            for j in range(k % p, N - k, 2 * k):
                for i in range(min(k, N - j - k)):
                    if (i + j) // (2 * p) == (i + j + k) // (2 * p):
                        pairs.append((i + j, i + j + k))
            k //= 2
        p *= 2
    return pairs


def _sort_wide(params, ctx, bkey, items, seeds, prune: int = 0):
    """`sort_wide` with its rotations' seed words given: W + 1 for each
    comparator in network order."""
    W = len(items[0])
    it = _iter(seeds)
    items = list(items)
    for i, j in _oddeven_pairs(len(items)):
        items[i], items[j] = _min_max_wide(params, ctx, bkey, items[i], items[j],
                                           [next(it) for _ in range(W + 1)], prune)
    return items


def sort_wide(params: Params, ctx: Scheme2Context, bkey: BootstrapKey,
              items: list[list[LWE]], seed_words=None, epoch: "int | None" = None,
              prune: int = 0) -> list[list[LWE]]:
    """Sort N encrypted W-digit numbers ascending, obliviously: a Batcher
    odd-even merge network of `min_max_wide` compare-exchanges (O(N log²N)
    comparators, each W + 1 rotation passes batched over B). The execution
    trace is data-independent."""
    count = len(_oddeven_pairs(len(items))) * (len(items[0]) + 1)
    return _sort_wide(params, ctx, bkey, items, _split(seed_words, epoch, count), prune)


def _eq_wide(params, ctx, bkey, xs, ys, seeds, prune: int = 0):
    """`eq_wide` with its 2W + 1 rotations' seed words given: W for each
    comparison, then the AND's."""
    W = len(xs)
    it = _iter(seeds)
    ge_xy = _sub_wide(params, ctx, bkey, xs, ys, [next(it) for _ in range(W)], prune)[1]
    ge_yx = _sub_wide(params, ctx, bkey, ys, xs, [next(it) for _ in range(W)], prune)[1]
    return _flag_and(params, ctx, bkey, ge_xy, ge_yx, next(it), prune)


def eq_wide(params: Params, ctx: Scheme2Context, bkey: BootstrapKey, xs: list[LWE],
            ys: list[LWE], seed_words=None, epoch: "int | None" = None, prune: int = 0) -> LWE:
    """Encrypted [x == y] flag: ge(x, y) AND ge(y, x), 2W + 1 rotations."""
    return _eq_wide(params, ctx, bkey, xs, ys, _split(seed_words, epoch, 2 * len(xs) + 1), prune)
