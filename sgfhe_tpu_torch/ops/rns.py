"""RNS context for the big modulus Q = prod(p_i), p_i < 2^30 (counterpart of
sgfhe_tpu/ops/rns.py).

The gadget decomposition is the balanced mixed-radix expansion over the
RNS primes, x = d_1 + d_2*p_1 + d_3*p_1*p_2 + ... with d_i in
(-p_i/2, p_i/2], so digit extraction is componentwise RNS arithmetic.
Tensors are int64 (..., L, m) residues; per-limb constants are (L, 1) and
per-(digit, limb) tables (L, L, 1).
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from ..utils import primes as pr
from ..utils import profiling
from . import modmath as mm
from . import prg

MASK32 = mm.MASK32


@dataclasses.dataclass(frozen=True)
class RnsContext:
    """Constants for Q = prod(p_i) as int64 tensors on one device."""

    moduli: tuple
    p: torch.Tensor             # (L, 1)
    mu: torch.Tensor            # (L, 1) floor(2^32/p)
    inv_pj_val: torch.Tensor    # (L, L): inv(p_j) mod p_i for j < i
    inv_pj_shoup: torch.Tensor  # (L, L)
    w_val: torch.Tensor         # (L, L, 1): w_i mod p_k, w_i = prod_{j<i} p_j
    w_shoup: torch.Tensor       # (L, L, 1)
    s_digit: torch.Tensor       # (L, 1): s_i = (p_i - 1) / 2
    s_mod: torch.Tensor         # (L, L, 1): s_i mod p_k
    offset: torch.Tensor        # (L, 1): sum_i w_i * s_i mod p_k
    close_primes: bool = False  # max(p) < 2*min(p): one conditional subtract


def build_context(moduli: tuple[int, ...]) -> "RnsContextHost":
    return RnsContextHost(tuple(int(p) for p in moduli))


class RnsContextHost:
    """Host-side companion holding Python-int constants; builds the device
    context."""

    def __init__(self, moduli: tuple[int, ...]):
        self.moduli = moduli
        self.L = len(moduli)
        self.Q = 1
        for p in moduli:
            self.Q *= p
        self.weights = []
        w = 1
        for p in moduli:
            self.weights.append(w)
            w *= p
        self.s = [(p - 1) // 2 for p in moduli]
        self.offset_int = sum(wi * si for wi, si in zip(self.weights, self.s)) % self.Q

    def tables(self) -> dict:
        """The context's constants as numpy int64 arrays."""
        L = self.L
        mods = self.moduli
        inv_pj_val = np.zeros((L, L), dtype=np.int64)
        inv_pj_shoup = np.zeros((L, L), dtype=np.int64)
        for i in range(L):
            for j in range(i):
                v = pr.inv_mod(mods[j], mods[i])
                inv_pj_val[i, j] = v
                inv_pj_shoup[i, j] = mm.shoup_const(v, mods[i])
        w_val = np.zeros((L, L, 1), dtype=np.int64)
        w_shoup = np.zeros((L, L, 1), dtype=np.int64)
        s_mod = np.zeros((L, L, 1), dtype=np.int64)
        for i in range(L):
            for k in range(L):
                wv = self.weights[i] % mods[k]
                w_val[i, k, 0] = wv
                w_shoup[i, k, 0] = mm.shoup_const(wv, mods[k])
                s_mod[i, k, 0] = self.s[i] % mods[k]
        return dict(
            p=np.array(mods, dtype=np.int64).reshape(L, 1),
            mu=np.array([mm.barrett_mu(q) for q in mods], dtype=np.int64).reshape(L, 1),
            inv_pj_val=inv_pj_val,
            inv_pj_shoup=inv_pj_shoup,
            w_val=w_val,
            w_shoup=w_shoup,
            s_digit=np.array(self.s, dtype=np.int64).reshape(L, 1),
            s_mod=s_mod,
            offset=np.array(
                [self.offset_int % q for q in mods], dtype=np.int64
            ).reshape(L, 1),
        )

    def device_context(self, device) -> RnsContext:
        tabs = {k: torch.as_tensor(v, device=device) for k, v in self.tables().items()}
        return RnsContext(
            moduli=self.moduli, close_primes=pr.close_primes(self.moduli), **tabs
        )


def flatten(ctx: RnsContext, x: torch.Tensor, prune: int = 0) -> torch.Tensor:
    """Balanced mixed-radix gadget decomposition.

    x: (..., L, m) residues of values in [0, Q). Returns (..., L - prune,
    L, m): digit i (balanced, d_i - s_i) embedded in every limb, for the
    kept digits i >= prune. sum_i w_i * digit_i == x (mod Q) when prune is
    0; the `prune` lowest digits are still extracted (the chain needs them)
    but not returned."""
    L = ctx.p.shape[0]
    y = mm.addmod(x, ctx.offset, ctx.p)
    digits = []
    for i in range(L):
        t = y[..., i, :]
        pi = ctx.p[i]
        for j in range(i):
            if ctx.close_primes:  # canonical mod p_j < 2*p_i: one cond-sub
                dj = torch.where(digits[j] >= pi, digits[j] - pi, digits[j])
            else:
                dj = mm.mod_u32(digits[j], pi)
            t = mm.submod(t, dj, pi)
            t = mm.shoup_mul(t, ctx.inv_pj_val[i, j], ctx.inv_pj_shoup[i, j], pi)
        digits.append(t)
    out = []
    for i in range(prune, L):
        d = digits[i][..., None, :]
        if ctx.close_primes:
            e = torch.where(d >= ctx.p, d - ctx.p, d)
        else:
            e = mm.mod_u32(d, ctx.p)
        out.append(mm.submod(e, ctx.s_mod[i], ctx.p))
    return torch.stack(out, dim=-3)


def mask_window_bits(p: int) -> int:
    """k such that the randomized-flatten mask window is [-2^k, 2^k): the
    smallest power of two with 2^k >= 3*s (s = (p-1)/2)."""
    s = (p - 1) // 2
    return (3 * s - 1).bit_length()


def mask_words(seed2, c0, step: int, ops, L: int) -> list:
    """The L uint32 flatten-mask words for counters (c0; step, op) under key
    seed2 = (seed_lo, seed_hi): one Threefry block per digit pair, all
    pairs of all `ops` in one call. Each word is (len(ops), *c0.shape)."""
    num_pairs = (L + 1) // 2
    c1 = torch.tensor([prg.mask_stream_c1(step, op, pair, num_pairs)
                       for op in ops for pair in range(num_pairs)],
                      dtype=torch.int64, device=c0.device)
    y0, y1 = prg.threefry2x32(seed2[0], seed2[1], c0,
                              c1.reshape((len(ops), num_pairs) + (1,) * c0.dim()))
    return [w for pair in range(num_pairs) for w in (y0[:, pair], y1[:, pair])][:L]


def flatten_random(
    ctx: RnsContext,
    x: torch.Tensor,
    moduli: tuple[int, ...],
    seed2,
    step: int,
    op=0,
    prune: int = 0,
    c0=None,
) -> torch.Tensor:
    """Randomized gadget decomposition: mask each kept digit with an exactly
    uniform value in [-2^k, 2^k) drawn from the documented Threefry stream
    (ops/prg.py), flatten the unmasked remainder, add the masks back.
    seed2 = (seed_lo, seed_hi) are Python ints; the per-element counter is
    gate * m + coeff with gate the row-major index over the leading batch
    axes. `op` is the operand's index in the stream; a tuple of them takes
    one operand each along x's first axis (the gate index then runs over
    the axes after it), so that one Threefry call draws every operand's
    masks. c0: the counters given instead, shaped as x without its limb
    axis (and without the operand axis of a tuple `op`): a caller that
    holds a column slice of the coefficient axis (the tensor-parallel
    rotation, parallel/rotate_dist.py) passes the global gate * m + coeff
    of each element, so that its masks are the single-device ones."""
    L = ctx.p.shape[0]
    m = x.shape[-1]
    stacked = isinstance(op, (tuple, list))
    ops = tuple(op) if stacked else (op,)
    batch = x.shape[1:-2] if stacked else x.shape[:-2]
    dev = x.device
    if c0 is None:
        ng = 1
        for b in batch:
            ng *= int(b)
        g = torch.arange(ng, dtype=torch.int64, device=dev).reshape(batch + (1,))
        c0 = g * m + torch.arange(m, dtype=torch.int64, device=dev)
    c0 = c0 & MASK32
    seed2 = (int(seed2[0]) & MASK32, int(seed2[1]) & MASK32)
    words = mask_words(seed2, c0, step, ops, L)
    if not stacked:
        words = [w[0] for w in words]
    off_mod = torch.tensor(
        [[(1 << mask_window_bits(p)) % q for q in moduli] for p in moduli],
        dtype=torch.int64, device=dev,
    )
    masks = []
    rand_x = x
    for i in range(prune, L):
        k_bits = mask_window_bits(moduli[i])
        v = words[i] & ((1 << (k_bits + 1)) - 1)
        e = mm.mod_u32(v[..., None, :], ctx.p)
        e = mm.submod(e, off_mod[i].reshape(L, 1), ctx.p)
        masks.append(e)
        contrib = mm.shoup_mul(e, ctx.w_val[i], ctx.w_shoup[i], ctx.p)
        rand_x = mm.submod(rand_x, contrib, ctx.p)
    y = flatten(ctx, rand_x, prune)
    return mm.addmod(y, torch.stack(masks, dim=-3), ctx.p)


def mixed_radix_digits(ctx: RnsContext, x: torch.Tensor) -> list:
    """Unbalanced mixed-radix digits of x (residues (..., L, m), values in
    [0, Q)): L tensors (..., m) with 0 <= d_i < p_i and x == sum_i d_i * w_i
    exactly."""
    L = ctx.p.shape[0]
    digits = []
    for i in range(L):
        t = x[..., i, :]
        pi = ctx.p[i]
        for j in range(i):
            t = mm.submod(t, mm.mod_u32(digits[j], pi), pi)
            t = mm.shoup_mul(t, ctx.inv_pj_val[i, j], ctx.inv_pj_shoup[i, j], pi)
        digits.append(t)
    return digits


# Multi-limb integers: little-endian lists of int64 tensors, each limb in
# [0, 2^32); every operation wraps mod 2^(32*NL), as the JAX version's
# uint32 limbs do.


def _limbs_of_int(v: int, nl: int) -> list[int]:
    return [(v >> (32 * j)) & MASK32 for j in range(nl)]


def _mll_add(a: list, b: list) -> list:
    """Multi-limb add, wrapping mod 2^(32*NL)."""
    out = []
    carry = 0
    for x, y in zip(a, b):
        s = x + y + carry
        carry = s >> 32
        out.append(s & MASK32)
    return out


def _mll_neg(a: list) -> list:
    """Two's-complement negation mod 2^(32*NL)."""
    out = []
    carry = 1
    for x in a:
        s = (x ^ MASK32) + carry
        carry = s >> 32
        out.append(s & MASK32)
    return out


def _mll_mul_const(d: torch.Tensor, k: int, nl: int) -> list:
    """d (uint32 values) times the Python int k, as an NL-limb list."""
    kl = _limbs_of_int(int(k), nl)
    zero = torch.zeros_like(d)
    acc = [zero] * nl
    for j in range(nl):
        if kl[j] == 0:
            continue
        hi, lo = mm.mulhilo(d, kl[j])
        part = [zero] * j + [lo] + ([hi] if j + 1 < nl else []) + [zero] * max(
            0, nl - j - 2
        )
        acc = _mll_add(acc, part)
    return acc


def _mll_ge_const(a: list, t: int) -> torch.Tensor:
    """a >= t (Python int), compared from the most significant limb."""
    tl = _limbs_of_int(int(t), len(a))
    gt = None
    eq = None
    for x, tv in zip(reversed(a), reversed(tl)):
        if gt is None:
            gt, eq = x > tv, x == tv
        else:
            gt = gt | (eq & (x > tv))
            eq = eq & (x == tv)
    return gt | eq


#: The kernel's bounds (csrc/rescale.cu): limbs of D and steps of the ladder.
SWITCH_NLMAX = 5
SWITCH_KMAX = 4
#: csrc/rescale.cu's SwitchConsts, field by field: (name, shape) in uint32
#: words (f and f_b hold float32 bit patterns).
SWITCH_FIELDS = (
    ("p", (4,)), ("inv_pj", (4, 4)), ("inv_pj_s", (4, 4)), ("f", (4,)), ("f_b", ()),
    ("aw", (4, SWITCH_NLMAX)), ("bkc", (SWITCH_NLMAX,)), ("ic", (2 * SWITCH_KMAX, SWITCH_NLMAX)),
    ("k", ()), ("mask", ()),
)


@dataclasses.dataclass(frozen=True)
class SwitchConsts:
    """The exact switch's constants for one (moduli, new_max, round_result):
    v = (A*x + B) / C (round: A = 2*new_max, B = Q, C = 2Q; floor: A =
    new_max, B = 0, C = Q), the ladder's K, D's limb count nl, the float32
    factors f32(A*w_i/C) and f32(B/C), and `words`, csrc/rescale.cu's
    SwitchConsts (SWITCH_FIELDS) that the kernel takes by value."""

    A: int
    B: int
    C: int
    K: int
    nl: int
    weights: tuple
    factors: tuple
    f_b: float
    words: np.ndarray


def _words_of(fields: dict) -> np.ndarray:
    out = []
    for name, shape in SWITCH_FIELDS:
        a = np.zeros(shape, dtype=np.uint32)
        v = np.asarray(fields[name])
        a[tuple(slice(0, n) for n in v.shape)] = v
        out.append(a.reshape(-1))
    return np.concatenate(out)


def switch_fields(words: np.ndarray) -> dict:
    """`SwitchConsts.words` cut back into SWITCH_FIELDS' named arrays."""
    out, at = {}, 0
    for name, shape in SWITCH_FIELDS:
        size = int(np.prod(shape, dtype=np.int64))
        out[name] = words[at:at + size].reshape(shape)
        at += size
    return out


@functools.lru_cache(maxsize=None)
def switch_consts(moduli: tuple[int, ...], new_max: int, round_result: bool) -> SwitchConsts:
    """The switch's constants, from the Python-int moduli alone (no device
    tensor is read), once per (moduli, new_max, round_result)."""
    assert new_max & (new_max - 1) == 0, "new_max must be a power of two"
    L = len(moduli)
    Q = 1
    weights = []
    for p in moduli:
        weights.append(Q)
        Q *= p
    if round_result:
        A, B, C = 2 * new_max, Q, 2 * Q
    else:
        A, B, C = new_max, 0, Q
    # float32 error budget: |est - v| < 3(L+2)*A*2^-23 (see the JAX version)
    K = max(1, -(-(3 * (L + 2) * A) // (1 << 23)))
    assert K <= SWITCH_KMAX, (
        f"rescale_exact: new_max={new_max} exceeds the float32 estimate "
        f"error budget for L={L} limbs (K={K} > {SWITCH_KMAX})"
    )
    nl = (A * (Q - 1) + B + (K + 1) * C).bit_length() // 32 + 1
    factors = tuple(float(np.float32(A * w / C)) for w in weights)
    f_b = float(np.float32(B / C)) if B else 0.0
    words = None
    if L <= 4 and nl <= SWITCH_NLMAX:  # the kernel's reach; beyond it, CPU only
        inv = np.zeros((L, L), dtype=np.uint32)
        inv_s = np.zeros((L, L), dtype=np.uint32)
        for i in range(L):
            for j in range(i):
                inv[i, j] = pr.inv_mod(moduli[j], moduli[i])
                inv_s[i, j] = mm.shoup_const(int(inv[i, j]), moduli[i])
        words = _words_of(dict(
            p=moduli, inv_pj=inv, inv_pj_s=inv_s,
            f=np.array(factors, dtype=np.float32).view(np.uint32),
            f_b=np.float32(f_b).view(np.uint32),
            aw=[_limbs_of_int(A * w, nl) for w in weights],
            bkc=_limbs_of_int(B + K * C, nl),
            ic=[_limbs_of_int(i * C, nl) for i in range(1, 2 * K + 1)],
            k=K, mask=new_max - 1,
        ))
        words.setflags(write=False)
    return SwitchConsts(A, B, C, K, nl, tuple(weights), factors, f_b, words)


def rescale_exact_plain(
    ctx: RnsContext,
    x: torch.Tensor,
    new_max: int,
    moduli: tuple[int, ...],
    round_result: bool = True,
) -> torch.Tensor:
    """Plain version of the switch kernel (csrc/rescale.cu), on any device:
    `rescale_exact` as eager int64 ops, about 315 launches on a card."""
    sc = switch_consts(tuple(int(p) for p in moduli), int(new_max), bool(round_result))
    digits = mixed_radix_digits(ctx, x)
    est = None
    for d, f in zip(digits, sc.factors):
        term = d.to(torch.float32) * f
        est = term if est is None else est + term
    if sc.B:
        est = est + sc.f_b
    est = torch.clamp(est, min=0.0)
    q_est = torch.floor(est).to(torch.int64)

    nl, K, C = sc.nl, sc.K, sc.C
    acc = [torch.full_like(q_est, v) for v in _limbs_of_int(sc.B + K * C, nl)]
    for d, w in zip(digits, sc.weights):
        acc = _mll_add(acc, _mll_mul_const(d, sc.A * w, nl))
    acc = _mll_add(acc, _mll_neg(_mll_mul_const(q_est, C, nl)))
    q = q_est - K
    for i in range(1, 2 * K + 1):
        q = q + _mll_ge_const(acc, i * C).to(torch.int64)
    return q & (new_max - 1)


def rescale_exact(
    ctx: RnsContext,
    x: torch.Tensor,
    new_max: int,
    moduli: tuple[int, ...],
    round_result: bool = True,
) -> torch.Tensor:
    """EXACT round/floor(x * new_max / Q) mod new_max for power-of-two
    new_max (the Q->r modulus switch). x: (..., L, m) residues of values in
    [0, Q); returns (..., m) int64.

    A float32 estimate of v = (A*x + B) / C (round: A=2*new_max, B=Q, C=2Q;
    floor: A=new_max, B=0, C=Q) is corrected by an exact multi-limb
    evaluation of D = A*x + B - (q_est - K)*C, which recovers the true
    quotient for any estimate within K of it. The float32 rounding may
    differ between devices; the ladder absorbs it, so the output does not.
    K = 1 through n = 8192 and 2 at n = 16384.

    A CUDA tensor (int64, any strides) takes the kernel csrc/rescale.cu, one
    launch counted in `rescale_exact.launches`, with no host sync and no
    upload: its constants go by value. A CPU tensor takes
    `rescale_exact_plain`; any other device raises."""
    with profiling.span("switch"):
        if x.device.type == "cpu":
            return rescale_exact_plain(ctx, x, new_max, moduli, round_result)
        if x.device.type != "cuda":
            raise ValueError(f"rescale_exact takes CUDA tensors (CPU tensors take the "
                             f"plain version), got {x.device}")
        sc = switch_consts(tuple(int(p) for p in moduli), int(new_max), bool(round_result))
        L, m = x.shape[-2], x.shape[-1]
        if L != len(moduli) or x.dtype != torch.int64:
            raise ValueError(f"rescale_exact: x must be int64 (..., {len(moduli)}, m), got "
                             f"{x.dtype} {tuple(x.shape)}")
        if sc.words is None:
            raise ValueError(f"rescale_exact: L = {L} limbs of D = {sc.nl} are beyond the "
                             f"kernel (L <= 4, at most {SWITCH_NLMAX} limbs)")
        out = torch.empty(x.shape[:-2] + (m,), dtype=torch.int64, device=x.device)
        if out.numel() == 0:
            return out
        x3 = x.reshape(-1, L, m)  # a view on the main path's layouts
        from .. import _build

        rc = _build.load("rescale.cu").sg_rescale_exact(
            x3.data_ptr(), out.data_ptr(), sc.words.ctypes.data, x3.shape[0], L, m, sc.nl,
            *x3.stride(), torch.cuda.current_stream().cuda_stream,
        )
        if rc != 0:
            raise RuntimeError(f"rescale_exact launch failed: cudaError {rc}")
        rescale_exact.launches += 1
        return out


rescale_exact.launches = 0


def rescale_wide(new_max: int, x: torch.Tensor, old_max: int,
                 round_result: bool) -> torch.Tensor:
    """EXACT floor/round(x * new_max / old_max) mod new_max for one modulus
    old_max < 2^31 and power-of-two new_max: the single-prime case of
    `rescale_exact`. The JAX package needs it for q beyond its uint32
    `modmath.rescale`; in int64 that function covers every single modulus,
    so this is it under the JAX package's name."""
    assert new_max & (new_max - 1) == 0, "new_max must be a power of two"
    return mm.rescale(new_max, x, old_max, round_result)
