"""Scheme-2 functional bootstrap: k-bit add with carry, lookup tables,
refresh and multiplication (counterpart of sgfhe_tpu/models/bootstrap2.py;
eprint 2019/521).

Every bootstrap here is one batched n-step blind rotation through the same
rotation as scheme 1 (models/bootstrap.blind_rotate): the CUDA kernels for
CUDA tensors (one rotate_resident launch for a key of at most 10 MiB, the
step pair above that) and their plain versions for CPU tensors, as
models/bootstrap._rotation_route picks. Each lane rotates its own test
vector T by its own phase φ = z·Dr + w; extracting coefficient 0 and
switching Q -> r gives a fresh encryption of f(z), with

    T[j] = f((j + Dr/2) ÷ Dr) · DQ        for j in [0, m − Dr/2)
    T[j] = (−f(0)) · DQ                   for j in [m − Dr/2, m)

(the top band catches small negative phases, which wrap negacyclically).
Lanes are gate-major: input g holds lanes [g·F, (g+1)·F), one per table, and
the randomized mask stream indexes lanes by that global position, so the
order is part of the output.

Randomized mode: each public entry folds a fresh epoch into its two seed
words (ops/prg.fold_epoch); `mul` then splits the folded words into one
pair per rotation round (ops/prg.split_words). The internal entries
(`bootstrap_internal`, `_add_with_carry`, `_mul`) take the folded words as
given and agree with the JAX package bit for bit on its words.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..ops import ntt as ntt_mod
from ..ops import poly as pol
from ..ops import prg
from ..ops import rns as rns_mod
from ..utils import profiling
from .bootstrap import blind_rotate
from .scheme1 import LWE
from .scheme2 import BootstrapKey, Params, PrivateKey, Scheme2Context


# ---------------------------------------------------------------------------
# LWE plumbing
# ---------------------------------------------------------------------------


def split_ciphertext(params: Params, a: torch.Tensor, b: torch.Tensor) -> LWE:
    """(a, b) polynomial ciphertext of n digits -> n LWEs, batched."""
    n = params.n
    length = a.shape[-1]
    dev = a.device
    i_idx = torch.arange(n, device=dev)[:, None]
    k_idx = torch.arange(n, device=dev)[None, :]
    g = a[..., (i_idx - k_idx) % length]
    g = torch.where(k_idx > i_idx, (-g) & params.mask_r, g)
    return LWE(g, b[..., :n])


def _phase(sk: PrivateKey, lwe: LWE) -> torch.Tensor:
    """b - a·s mod r."""
    return (lwe.b - (lwe.a * sk.key).sum(-1)) & sk.params.mask_r


def decrypt_lwe(sk: PrivateKey, lwe: LWE) -> torch.Tensor:
    """Batched LWE decryption -> digit in [0, 2^{k+2}) (snap to multiples
    of Dr, reference src/fhe2.jl:229-235)."""
    params = sk.params
    return ((_phase(sk, lwe) + params.Dr // 2) & params.mask_r) // params.Dr


def lwe_phase_noise(sk: PrivateKey, lwe: LWE, message: torch.Tensor) -> torch.Tensor:
    """Signed phase noise (b − a·s) − message·Dr, centred to (−r/2, r/2]."""
    params = sk.params
    w = (_phase(sk, lwe) - torch.as_tensor(message, device=lwe.b.device) * params.Dr) \
        & params.mask_r
    return torch.where(w > params.r // 2, w - params.r, w)


# ---------------------------------------------------------------------------
# Test vectors
# ---------------------------------------------------------------------------


def make_table(params: Params, f_values) -> np.ndarray:
    """The (L, m) residue table T of a function over combined digits z in
    [0, 2^{k+1}) (module docstring). f_values: 2^{k+1} ints."""
    zmax = 2 ** (params.k + 1)
    f_values = [int(v) for v in f_values]
    assert len(f_values) == zmax, (len(f_values), zmax)
    m, Dr = params.m, params.Dr
    half = Dr // 2
    z = np.minimum((np.arange(m) + half) // Dr, zmax - 1)  # top band set below
    T = np.zeros((len(params.moduli), m), dtype=np.int64)
    for li, p in enumerate(params.moduli):
        dq = params.DQ % p
        T[li] = np.array([f * dq % p for f in f_values], dtype=np.int64)[z]
        T[li, m - half:] = (-f_values[0] * dq) % p
    return T


def tables_hat(params: Params, ctx: Scheme2Context, f_tables) -> torch.Tensor:
    """F function tables -> (F, L, m) NTT-domain test vectors."""
    T = np.stack([make_table(params, f) for f in f_tables])
    return ntt_mod.ntt_fwd(ctx.plan_Q, torch.as_tensor(T, device=ctx.device))


# ---------------------------------------------------------------------------
# The bootstrap
# ---------------------------------------------------------------------------


def _rotate_extract(params: Params, ctx: Scheme2Context, bkey_hat, bkey_shoup,
                    ua, ub, t0, seed2=None, prune: int = 0, *, rotate=None) -> LWE:
    """Rotate each lane's test vector t0 (M, L, m) (hat domain) by its phase
    (ua (M, n), ub (M,) mod r), extract coefficient 0, switch Q -> r.
    rotate: None (`blind_rotate` on bkey_hat/bkey_shoup) or another
    rotation, as in models/bootstrap.bootstrap_internal."""
    with profiling.span("bootstrap"):
        n, m = params.n, params.m
        plan = ctx.plan_Q
        shift = (2 * m - ub) & (2 * m - 1)
        b_acc = ntt_mod.ntt_inv(plan, ntt_mod.monomial_mul_hat(plan, t0, shift))
        a_acc = torch.zeros_like(b_acc)
        if rotate is None:
            rotate = functools.partial(blind_rotate, params, ctx, bkey_hat, bkey_shoup)
        a_acc, b_acc = rotate(ua, a_acc, b_acc, seed2=seed2, prune=prune)
        a_q = pol.extract(a_acc, 0, n, plan.p)  # (M, L, n)
        a_r = rns_mod.rescale_exact(ctx.rns_Q, a_q, params.r, params.moduli)
        b_r = rns_mod.rescale_exact(ctx.rns_Q, b_acc[..., :1], params.r, params.moduli)[..., 0]
        return LWE(a_r, b_r)


def bootstrap_internal(params: Params, ctx: Scheme2Context, bkey_hat, bkey_shoup,
                       lwe_u: LWE, t_hats, seed2=None, prune: int = 0, *, rotate=None) -> LWE:
    """F functions of each phase of lwe_u ((B, n)/(B,)) in one rotation of
    B·F gate-major lanes; seed2 used as given. Returns (B, F, n)/(B, F)."""
    B, F = lwe_u.a.shape[0], t_hats.shape[0]
    out = _rotate_extract(
        params, ctx, bkey_hat, bkey_shoup, lwe_u.a.repeat_interleave(F, dim=0),
        lwe_u.b.repeat_interleave(F, dim=0), t_hats.repeat(B, 1, 1), seed2, prune, rotate=rotate,
    )
    return LWE(out.a.reshape(B, F, params.n), out.b.reshape(B, F))


def bootstrap(params: Params, ctx: Scheme2Context, bkey: BootstrapKey, lwe_u: LWE,
              t_hats, seed_words=None, epoch: "int | None" = None, prune: int = 0) -> LWE:
    """Evaluate F functions of the phase of lwe_u in one batched rotation:
    out[:, f] is a fresh encryption of the f-th function of z. seed_words:
    None (deterministic) or two uint32 words, with a fresh epoch folded in
    per call unless `epoch` pins it."""
    return bootstrap_internal(params, ctx, bkey.hat, bkey.hat_shoup, lwe_u, t_hats,
                              prg.fold_epoch(seed_words, epoch), prune)


def _lwe_sum(params: Params, *lwes: LWE) -> LWE:
    a, b = lwes[0].a, lwes[0].b
    for x in lwes[1:]:
        a, b = a + x.a, b + x.b
    return LWE(a & params.mask_r, b & params.mask_r)


def _select(out: LWE, f: int) -> LWE:
    return LWE(out.a[:, f], out.b[:, f])


def _add_with_carry(params, ctx, bkey, lwe1, lwe2, carry, seed2, prune: int = 0, *, rotate=None):
    """add_with_carry on seed words used as given; bkey is None when
    `rotate` brings its own key."""
    k = params.k
    zmax = 2 ** (k + 1)
    u = _lwe_sum(params, lwe1, lwe2) if carry is None else _lwe_sum(params, lwe1, lwe2, carry)
    th = tables_hat(params, ctx, [[z % 2**k for z in range(zmax)],
                                  [int(z >= 2**k) for z in range(zmax)]])
    hat, shoup = (None, None) if bkey is None else (bkey.hat, bkey.hat_shoup)
    out = bootstrap_internal(params, ctx, hat, shoup, u, th, seed2, prune, rotate=rotate)
    return _select(out, 0), _select(out, 1)


def add_with_carry(params: Params, ctx: Scheme2Context, bkey: BootstrapKey, lwe1: LWE,
                   lwe2: LWE, carry: "LWE | None" = None, seed_words=None,
                   epoch: "int | None" = None, prune: int = 0) -> tuple[LWE, LWE]:
    """k-bit addition with carry: refreshed encryptions of (x + y + c) mod
    2^k and of the carry-out (x + y + c) >= 2^k, from one rotation (the two
    output functions ride as adjacent lanes)."""
    with profiling.span("digits"):
        return _add_with_carry(params, ctx, bkey, lwe1, lwe2, carry,
                               prg.fold_epoch(seed_words, epoch), prune)


def apply_lut(params: Params, ctx: Scheme2Context, bkey: BootstrapKey, lwe: LWE, lut,
              seed_words=None, epoch: "int | None" = None, prune: int = 0) -> LWE:
    """Any unary digit function f: [0, 2^k) -> [0, 2^k), `lut` its 2^k
    values, in one rotation. Single inputs never reach z >= 2^k, so the
    upper half of the table repeats the lower."""
    lut = list(lut)
    assert len(lut) == 2**params.k
    th = tables_hat(params, ctx, [lut + lut])
    return _select(bootstrap(params, ctx, bkey, lwe, th, seed_words, epoch, prune), 0)


def refresh(params: Params, ctx: Scheme2Context, bkey: BootstrapKey, lwe: LWE,
            seed_words=None, epoch: "int | None" = None) -> LWE:
    """Noise reset: the identity table."""
    return apply_lut(params, ctx, bkey, lwe, range(2**params.k), seed_words, epoch)


# ---------------------------------------------------------------------------
# k-bit multiplication
# ---------------------------------------------------------------------------


def _shifted_diff(params: Params, x: LWE, *subtract: LWE) -> LWE:
    """x - sum(subtract) + K·Dr mod r: a phase offset into (0, 2K)."""
    K = 2**params.k
    a, b = x.a, x.b + K * params.Dr
    for y in subtract:
        a, b = a - y.a, b - y.b
    return LWE(a & params.mask_r, b & params.mask_r)


def _mul(params, ctx, bkey, lwe1, lwe2, seeds, prune: int = 0):
    """The three rotation rounds of `mul`; seeds: three seed-word pairs (or
    None each), used as given."""
    K = 2**params.k
    B, n = lwe1.a.shape[0], params.n
    hat, shoup = bkey.hat, bkey.hat_shoup
    # round 1: quarter-squares of z_sum = x + y and z_diff = x - y + K, each
    # split into its low and high digits; gate-major lanes (sum, sum, diff,
    # diff) against tables (0, 1, 2, 3)
    u_sum = _lwe_sum(params, lwe1, lwe2)
    u_diff = _shifted_diff(params, lwe1, lwe2)
    qs_sum = [(z * z) // 4 for z in range(2 * K)]
    qs_diff = [((z - K) * (z - K)) // 4 for z in range(2 * K)]
    th4 = tables_hat(params, ctx, [[q % K for q in qs_sum], [q // K for q in qs_sum],
                                   [q % K for q in qs_diff], [q // K for q in qs_diff]])
    ua = torch.stack([u_sum.a, u_sum.a, u_diff.a, u_diff.a], dim=1).reshape(4 * B, n)
    ub = torch.stack([u_sum.b, u_sum.b, u_diff.b, u_diff.b], dim=1).reshape(4 * B)
    out1 = _rotate_extract(params, ctx, hat, shoup, ua, ub, th4.repeat(B, 1, 1), seeds[0], prune)
    s_lo, s_hi, d_lo, d_hi = (LWE(out1.a[i::4], out1.b[i::4]) for i in range(4))

    # round 2: v = s_lo - d_lo in (-K, K): v mod K and the borrow [v < 0]
    th2 = tables_hat(params, ctx, [[(z - K) % K for z in range(2 * K)],
                                   [int(z < K) for z in range(2 * K)]])
    out2 = bootstrap_internal(params, ctx, hat, shoup, _shifted_diff(params, s_lo, d_lo),
                              th2, seeds[1], prune)
    lo, borrow = _select(out2, 0), _select(out2, 1)

    # round 3: the high digit s_hi - d_hi - borrow, in [0, K) for a product
    th1 = tables_hat(params, ctx, [[(z - K) % K for z in range(2 * K)]])
    out3 = bootstrap_internal(params, ctx, hat, shoup,
                              _shifted_diff(params, s_hi, d_hi, borrow), th1, seeds[2], prune)
    return lo, _select(out3, 0)


def mul(params: Params, ctx: Scheme2Context, bkey: BootstrapKey, lwe1: LWE, lwe2: LWE,
        seed_words=None, epoch: "int | None" = None, prune: int = 0) -> tuple[LWE, LWE]:
    """k-bit digit multiplication x·y -> (low digit, high digit), both
    refreshed, by the quarter-squares identity x·y = ⌊(x+y)²/4⌋ − ⌊(x−y)²/4⌋
    in three rotation rounds (4, 2 and 1 lanes a pair)."""
    seed2 = prg.fold_epoch(seed_words, epoch)
    seeds = (None,) * 3 if seed2 is None else prg.split_words(seed2, 3)
    return _mul(params, ctx, bkey, lwe1, lwe2, seeds, prune)
