"""Gate bootstrap (counterpart of sgfhe_tpu/models/bootstrap.py; reference
src/fhe.jl:519-621).

Every function carries a leading batch axis of gates. The bootstrap key
lives in the NTT domain with Shoup companions, and each of the n rotation
steps is one external product (a, b) <- (a, b) ⊙ ((x^{u_k}-1)·C_k + G):
flatten both accumulators into balanced digits, forward NTT, Shoup MAC
against the key, multiply by x^{u_k} in the hat domain, inverse NTT.

The rotation runs either as the twin (`_external_step`, plain PyTorch, the
counterpart of the JAX package's jnp path) or through CUDA kernels.
`_rotation_route` picks by the tensors' device and the key's size, never by
an environment variable, as the JAX package's `_use_fused` does: CPU
tensors take the twin; on CUDA tensors a key of at most 10 MiB with its
companions takes "resident", the whole rotation in one launch
(ops/fused.blind_rotate_fused, the JAX package's resident kernel) in every
mode and at every prune, and a larger key "wmul", the step pair with the
T-term by w-multiplies, 2n launches (ops/fused.blind_rotate_steps, its
streamed kernel). `plain=True` forces the twin on any device.

Deterministic by default; pass two Threefry seed words for randomized
flattening (ops/prg.py).

`pack_encrypted_bits` repacks n bootstrapped bits into one RLWE over
R_{m,r} (reference src/fhe.jl:632-696): n trivial bootstraps through the
same rotation, then n shortened external products in plain torch.
"""

from __future__ import annotations

import functools

import torch

from ..ops import fused as fused_mod
from ..ops import modmath as mm
from ..ops import ntt as ntt_mod
from ..ops import poly as pol
from ..ops import prg
from ..ops import rns as rns_mod
from ..utils import profiling
from .params import Params, prune_error_bound
from .scheme1 import LWE, RLWE, Ciphertext, EncryptedBit, SchemeContext

_RESIDENT_KEY_BYTES = 10 * 1024 * 1024


def _rotation_route(params: Params, device: torch.device, prune: int,
                    plain: bool) -> str:
    """'plain' (the twin), 'resident' or 'wmul' (the CUDA kernels). Every
    prune takes the route of prune 0, as in the JAX package."""
    if plain or device.type == "cpu":
        return "plain"
    if device.type != "cuda":
        raise ValueError(f"no rotation path for device {device}")
    resident = fused_mod.fused_bkey_bytes(params) <= _RESIDENT_KEY_BYTES
    return "resident" if resident else "wmul"


def _external_step(params: Params, ctx: SchemeContext, a_acc, b_acc, ck_hat,
                   ck_shoup, u_k, seed2, step_k: int, prune: int = 0):
    """One blind-rotation step of the twin. a_acc, b_acc: (B, L, m) int64;
    ck_hat/ck_shoup: (2l, 2, L, m) int64; u_k: (B,) mod 2m; seed2: None or
    the two Threefry key words."""
    d_hat = fused_mod.flatten_ntt_fwd_i64(ctx, a_acc, b_acc, seed2, step_k, prune)
    a, b, _, _ = fused_mod.mac_rotate_ntt_inv_i64(ctx, d_hat, ck_hat, ck_shoup, u_k, prune)
    return a, b


def check_prune(params: Params, prune: int) -> None:
    """Refuse a digit pruning whose admitted noise reaches the Dr/16 guard."""
    if prune:
        bound = prune_error_bound(params, prune)
        assert bound < params.Dr / 16, (
            f"digit pruning prune={prune} admits post-rescale noise "
            f"{bound:.3g}, too close to the Dr/4 = {params.Dr // 4} decision "
            f"budget (guard: < Dr/16 = {params.Dr / 16:.3g})"
        )


def blind_rotate(params, ctx, bkey_hat, bkey_shoup, ua, a_acc, b_acc,
                 seed2=None, prune: int = 0, *, plain: bool = False):
    """The n-step rotation: (a, b) <- (a, b) ⊙ ((x^{u_k}-1)·C_k + G) for
    k = 0..n-1, batched. ua: (B, n) exponents mod 2m; a_acc, b_acc:
    (B, L, m) int64; bkey_hat/bkey_shoup: (n, 2l, 2, L, m) int32."""
    with profiling.span("rotate"):
        n = params.n
        check_prune(params, prune)
        route = _rotation_route(params, a_acc.device, prune, plain)
        if route == "resident":
            return fused_mod.blind_rotate_fused(ctx, bkey_hat, ua, a_acc, b_acc, seed2, prune)
        if route == "wmul":
            fused_mod.check_envelope(params)
            return fused_mod.blind_rotate_steps(
                ctx, bkey_hat, bkey_shoup, ua, a_acc, b_acc, seed2, prune,
            )
        for k in range(n):
            a_acc, b_acc = _external_step(
                params, ctx, a_acc, b_acc, mm.u32(bkey_hat[k]), mm.u32(bkey_shoup[k]),
                ua[:, k], seed2, k, prune,
            )
        return a_acc, b_acc


def bootstrap_internal(params: Params, ctx: SchemeContext, bkey_hat, bkey_shoup,
                       a1, b1, a2, b2, seed2=None, prune: int = 0, *,
                       plain: bool = False, rotate=None):
    """Blind rotation + gate extraction (reference src/fhe.jl:559-595),
    batched. a1, a2: (B, n); b1, b2: (B,); all mod r. seed2: None or the two
    Threefry key words, used as given. rotate: None (`blind_rotate` on
    bkey_hat/bkey_shoup) or another rotation, called as
    rotate(ua, a_acc, b_acc, seed2=, prune=) (the tensor-parallel one of
    parallel/rotate_dist.py, which brings its own key). Returns three LWEs
    over Q as ((B, L, n), (B, L)) pairs: AND, OR, XOR."""
    with profiling.span("bootstrap"):
        n, m, L = params.n, params.m, params.num_limbs
        mask = params.mask_r
        plan = ctx.plan_Q
        ua = (a1 + a2) & mask
        ub = (b1 + b2) & mask
        batch = ua.shape[0]
        # b0 = t(x) * DQ~ * x^{-ub}, rotated in the hat domain
        tpoly_hat_b = ctx.tpoly_dq_hat.expand(batch, L, m)
        shift = (2 * m - ub) & (2 * m - 1)
        b_acc = ntt_mod.ntt_inv(plan, ntt_mod.monomial_mul_hat(plan, tpoly_hat_b, shift))
        a_acc = torch.zeros((batch, L, m), dtype=torch.int64, device=b_acc.device)

        if rotate is None:
            rotate = functools.partial(blind_rotate, params, ctx, bkey_hat, bkey_shoup,
                                       plain=plain)
        a_acc, b_acc = rotate(ua, a_acc, b_acc, seed2=seed2, prune=prune)

        i_and = 3 * m // 4
        i_or = m // 4
        p = plan.p
        a_and = pol.extract(a_acc, i_and, n, p)
        b_and = mm.addmod(ctx.dq_tilde[:, 0], b_acc[..., i_and], p[:, 0])
        a_or = mm.negmod(pol.extract(a_acc, i_or, n, p), p)
        b_or = mm.submod(ctx.dq_tilde[:, 0], b_acc[..., i_or], p[:, 0])
        a_xor = mm.submod(a_or, a_and, p)
        b_xor = mm.submod(b_or, b_and, p[:, 0])
        return (a_and, b_and), (a_or, b_or), (a_xor, b_xor)


def _reduce_lwe(params: Params, ctx: SchemeContext, lwe_q) -> LWE:
    """Modulus switch Q -> r on an RNS LWE (reference src/fhe.jl:616-618)."""
    a_q, b_q = lwe_q
    a_r = rns_mod.rescale_exact(ctx.rns, a_q, params.r, params.moduli)
    b_r = rns_mod.rescale_exact(ctx.rns, b_q[..., None], params.r, params.moduli)[..., 0]
    return LWE(a_r, b_r)


def bootstrap_batch(params: Params, ctx: SchemeContext, bkey_hat, bkey_shoup,
                    lwe1: LWE, lwe2: LWE, seed_words=None,
                    epoch: "int | None" = None, prune: int = 0, *,
                    plain: bool = False):
    """Batched gate bootstrap: returns (AND, OR, XOR) LWE batches mod r
    (reference src/fhe.jl:608-621).

    seed_words: None (deterministic) or two uint32 words for randomized
    flattening; a fresh epoch is folded in per call (ops/prg.fold_epoch) so
    repeated calls never replay a mask stream; pass `epoch` to pin it.
    prune > 0 drops the `prune` lowest digit rows (approximate gadget; the
    admitted noise is asserted < Dr/16)."""
    with profiling.span("gates"):
        seed2 = prg.fold_epoch(seed_words, epoch)
        triple = bootstrap_internal(
            params, ctx, bkey_hat, bkey_shoup, lwe1.a, lwe1.b, lwe2.a, lwe2.b,
            seed2, prune, plain=plain,
        )
        return tuple(_reduce_lwe(params, ctx, t) for t in triple)


def bootstrap(params, ctx, bkey, enc_bit1: EncryptedBit, enc_bit2: EncryptedBit,
              seed_words=None, epoch: "int | None" = None):
    """Single- or batched-gate convenience wrapper returning EncryptedBits."""
    a1, a2 = torch.atleast_2d(enc_bit1.lwe.a), torch.atleast_2d(enc_bit2.lwe.a)
    b1, b2 = torch.atleast_1d(enc_bit1.lwe.b), torch.atleast_1d(enc_bit2.lwe.b)
    res = bootstrap_batch(
        params, ctx, bkey.hat, bkey.hat_shoup, LWE(a1, b1), LWE(a2, b2),
        seed_words, epoch,
    )
    if enc_bit1.lwe.a.ndim == 1:
        return tuple(EncryptedBit(LWE(r.a[0], r.b[0])) for r in res)
    return tuple(EncryptedBit(r) for r in res)


# ---------------------------------------------------------------------------
# LWE repacking (reference src/fhe.jl:632-696)
# ---------------------------------------------------------------------------


def pack_internal(params: Params, ctx: SchemeContext, bkey_hat, bkey_shoup,
                  enc_bits: LWE, boot_seed2=None, pack_seed2=None, *,
                  plain: bool = False, keys: slice = slice(None), gather=None,
                  reduce=None) -> RLWE:
    """n LWE bits (n, n)/(n,) -> one RLWE over R_{m,r} (reference
    src/fhe.jl:660-696). The n trivial-input bootstraps run as one batch of
    n gates through the rotation; the n shortened external products are
    plain torch. boot_seed2 / pack_seed2: None or the two Threefry key
    words of the bootstraps' and of the pack stage's mask streams, used as
    given.

    keys, gather and reduce split the work over ranks
    (parallel/sharded.pack_encrypted_bits_sharded, deterministic mode):
    this rank bootstraps the bits `keys` and multiplies the key indices
    `keys`; gather(x) concatenates every rank's bootstrapped bits along
    the leading axis, and reduce(x) turns the ranks' partial sums over key
    indices, (2, L, m) mod p each, into the total mod p."""
    n, m, l = params.n, params.m, params.num_digits
    plan = ctx.plan_Q
    p = plan.p
    a_bits, b_bits = enc_bits.a[keys], enc_bits.b[keys]
    shard, dev = a_bits.shape[0], a_bits.device
    # trivial LWE encrypting 1: a = 0, b = Dr (src/fhe.jl:670-671)
    a_triv = torch.zeros((shard, n), dtype=torch.int64, device=dev)
    b_triv = torch.full((shard,), params.Dr, dtype=torch.int64, device=dev)
    (a_q, b_q), _, _ = bootstrap_internal(
        params, ctx, bkey_hat, bkey_shoup, a_triv, b_triv, a_bits, b_bits,
        boot_seed2, plain=plain,
    )
    if gather is not None:
        a_q, b_q = gather(a_q), gather(b_q)
    # polynomial i collects coefficient i of every gate's LWE (src/fhe.jl:675-678)
    as_polys = pol.resize(a_q.permute(2, 1, 0)[keys], m)  # (n, L, m)
    b_poly = pol.resize(b_q.t(), m)                       # (L, m)

    # shortened external products against rows l..2l-1 (src/fhe.jl:632-641);
    # the pack stage's mask stream takes step n, one beyond every rotation
    # step, with the key-polynomial index as its gate axis
    if pack_seed2 is None:
        d = rns_mod.flatten(ctx.rns, as_polys)  # (n, l, L, m)
    else:
        assert keys == slice(None), "randomized pack: one rank holds every key index"
        d = rns_mod.flatten_random(ctx.rns, as_polys, params.moduli, pack_seed2, n, op=0)
    d_hat = ntt_mod.ntt_fwd(plan, d)
    sums = []
    for c in range(2):
        acc = None
        for i in range(l):
            prod = mm.shoup_mul(d_hat[:, i], mm.u32(bkey_hat[keys, l + i, c]),
                                mm.u32(bkey_shoup[keys, l + i, c]), p)  # (n, L, m)
            acc = prod if acc is None else mm.addmod(acc, prod, p)
        # the sum over key indices (src/fhe.jl:686-687) in the hat domain
        sums.append(_sum_mod(acc, p))
    sums = torch.stack(sums)
    if reduce is not None:
        sums = reduce(sums)
    w_sum, v_sum = ntt_mod.ntt_inv(plan, sums)
    w1 = mm.negmod(w_sum, p)
    v1 = mm.submod(b_poly, v_sum, p)
    return RLWE(rns_mod.rescale_exact(ctx.rns, w1, params.r, params.moduli),
                rns_mod.rescale_exact(ctx.rns, v1, params.r, params.moduli))


def _sum_mod(x, p):
    """Tree sum over the leading axis, each level reduced (pairwise addmod)."""
    while x.shape[0] > 1:
        k = x.shape[0]
        if k % 2 == 1:
            x = torch.cat([x, torch.zeros_like(x[:1])])
            k += 1
        x = mm.addmod(x[:k // 2], x[k // 2:], p)
    return x[0]


def pack_encrypted_bits(params: Params, ctx: SchemeContext, bkey,
                        enc_bits: EncryptedBit, seed_words=None,
                        epoch: "int | None" = None, *, plain: bool = False) -> Ciphertext:
    """n EncryptedBits -> one Ciphertext over R_{m,r}.

    seed_words: None (deterministic) or two uint32 words; a fresh epoch is
    folded in per call (ops/prg.fold_epoch) and the folded words are split
    into the bootstraps' and the pack stage's (ops/prg.split_words)."""
    seed2 = prg.fold_epoch(seed_words, epoch)
    boot, pack = (None, None) if seed2 is None else prg.split_words(seed2, 2)
    rlwe = pack_internal(params, ctx, bkey.hat, bkey.hat_shoup, enc_bits.lwe, boot, pack,
                         plain=plain)
    return Ciphertext(params, rlwe)
