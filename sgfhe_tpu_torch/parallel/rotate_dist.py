"""Tensor-parallel blind rotation: the polynomial/hat axis m spans the 'tp'
mesh axis through the four-step distributed NTT (parallel/ntt_dist.py);
counterpart of sgfhe_tpu/parallel/rotate_dist.py, on `torch.distributed`.

This is the path to bootstrap keys larger than one card's memory: each
rank needs only a 1/D row slice of every bootstrap-key step (hat rows),
the small (batch, L, m/D) accumulators move between the coefficient and
hat domains by the four-step NTT's `all_to_all_single`s, and all other
work (flatten, gadget accumulation, monomial ladder) is pointwise in
whichever domain it runs, so it shards for free.

The JAX package's rotation here is plain jnp and reaches no
`pl.pallas_call`; this counterpart is plain torch on any device, not a
kernel, and the Python loop runs the n steps one by one. On one card the
group is NCCL at world size 1, where each exchange is a copy.

Layouts (D = the tp group's size, idx = this rank's index in it):
  coefficient domain: (..., L, m1, m2), rank idx holds m2/D columns
  hat domain:         (..., L, m1, m2), rank idx holds m1/D rows
  bootstrap key:      (n, 2l, 2, L, m1, m2) hat, int32 bit patterns, of
                      which a rank holds its m1/D rows (`bkey_to_dist(part=...)`)

Hat-position evaluation map: position (pos1, pos2) evaluates the polynomial
at ψ^{E}, E = 1 + 2*(br1(pos1) + m1*br2(pos2)) mod 2m (tests:
tests/test_torch_rotate_dist.py). The monomial bit-ladder tables are
precomputed on that map, so the rotation's (x^u - 1)·C products stay
gather-free.

Per step the communication is two all_to_alls of the digit and accumulator
tiles; the key never moves. Both flattening modes work: randomized masks
come from the documented Threefry counter stream (ops/prg.py) on global
(gate, coefficient) counters (ops/rns.flatten_random's c0), so the
sharded rotation equals models/bootstrap.blind_rotate bit for bit in both
modes and with digit pruning.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch
import torch.distributed as dist

from ..models import bootstrap as bs
from ..models import bootstrap2 as bs2
from ..models.scheme1 import KEY_CHUNK_BYTES, LWE
from ..ops import modmath as mm
from ..ops import ntt as ntt_mod
from ..ops import prg
from ..ops import rns as rns_mod
from ..utils import primes as pr
from . import ntt_dist as nd


@dataclasses.dataclass(frozen=True)
class DistRotationPlan:
    """Four-step NTT plan + monomial-ladder tables in the dist-hat order."""

    dplan: nd.DistNttPlan
    mono: torch.Tensor    # (nbits, L, m1, m2): ψ^{E[pos]·2^b mod 2m}
    mono_s: torch.Tensor

    @property
    def m1(self) -> int:
        return self.dplan.tw.shape[-2]

    @property
    def m2(self) -> int:
        return self.dplan.tw.shape[-1]


def rotation_tables_host(moduli: tuple[int, ...], m1: int, m2: int):
    """The E map (m1, m2) and the ladder tables (nbits, L, m1, m2) as numpy
    uint64, with their Shoup companions (the JAX package's host loops)."""
    m = m1 * m2
    L = len(moduli)
    br1 = ntt_mod._bit_reverse_indices(m1)
    br2 = ntt_mod._bit_reverse_indices(m2)
    E = (1 + 2 * (br1[:, None] + m1 * br2[None, :])) % (2 * m)  # (m1, m2)
    nbits = (2 * m).bit_length() - 1
    mono = np.zeros((nbits, L, m1, m2), dtype=np.uint64)
    for li, p in enumerate(moduli):
        psi = pr.root_of_unity(2 * m, p)
        psi_pow = np.zeros(2 * m, dtype=np.uint64)
        cur = 1
        for k in range(2 * m):
            psi_pow[k] = cur
            cur = cur * psi % p
        for b in range(nbits):
            mono[b, li] = psi_pow[(E << b) % (2 * m)]
    mono_s = np.stack([ntt_mod._shoup_table(x, moduli) for x in mono])
    return E, mono, mono_s


def build_rotation_plan(moduli: tuple[int, ...], m1: int, m2: int, device) -> DistRotationPlan:
    """Host-side construction (exact Python-int arithmetic), tables moved to
    `device`."""
    moduli = tuple(int(p) for p in moduli)
    _, mono, mono_s = rotation_tables_host(moduli, m1, m2)
    return DistRotationPlan(
        dplan=nd.build_dist_plan(moduli, m1, m2, device),
        mono=torch.as_tensor(mono.astype(np.int64), device=device),
        mono_s=torch.as_tensor(mono_s.astype(np.int64), device=device),
    )


def fwd_full(dplan: nd.DistNttPlan, x: torch.Tensor) -> torch.Tensor:
    """Unsharded reference of the distributed forward transform (at D = 1
    the exchange is the identity): pre-twist -> m1-NTT -> inter twiddle ->
    m2-NTT. x: (..., L, m1, m2) coefficients (flat index i1*m2 + i2)."""
    p = dplan.plan1.p[..., None]
    x = mm.shoup_mul(x, dplan.pre, dplan.pre_s, p)
    x = nd._ntt_axis(dplan.plan1, x, inverse=False)
    x = mm.shoup_mul(x, dplan.tw, dplan.tw_s, p)
    return nd.fwd_finish(dplan, x)


def inv_full(dplan: nd.DistNttPlan, x: torch.Tensor) -> torch.Tensor:
    """Unsharded inverse of `fwd_full`."""
    p = dplan.plan1.p[..., None]
    x = nd.inv_start(dplan, x)
    x = mm.shoup_mul(x, dplan.tw_inv, dplan.tw_inv_s, p)
    x = nd._ntt_axis(dplan.plan1, x, inverse=True)
    return mm.shoup_mul(x, dplan.post, dplan.post_s, p)


def _kept_rows(l: int, prune: int) -> list:
    return list(range(prune, l)) + list(range(l + prune, 2 * l))


def bkey_to_dist(ctx, rplan: DistRotationPlan, bkey_hat: torch.Tensor, prune: int = 0,
                 part: "tuple[int, int] | None" = None) -> torch.Tensor:
    """A bootstrap key (n, 2l, 2, L, m) in the single-device hat order
    (int32 bit patterns) -> the dist-hat order: hat -> coefficients
    (inverse NTT) -> four-step hat. Runs on the key's device a chunk of key
    indices at a time (as models/scheme1._seeded_key builds keys), and
    returns int32 bit patterns of shape (n, 2l, 2, L, m1, m2). No Shoup
    companions: the rotation's MAC reduces its products by remainder, so
    the converted key is half the size of the single-device one.

    prune > 0 converts (and returns) only the kept gadget rows
    [prune, l) + [l+prune, 2l), shape (n, 2(l-prune), 2, L, m1, m2); pass
    the result to blind_rotate_dist with the same `prune`. part = (index,
    count) keeps only hat rows [index*m1/count, (index+1)*m1/count): the
    share of tp rank `index` in a group of `count`."""
    m1, m2 = rplan.m1, rplan.m2
    n, rows2 = bkey_hat.shape[:2]
    keep = _kept_rows(rows2 // 2, prune) if prune else list(range(rows2))
    r0, r1 = (0, m1) if part is None else (part[0] * m1 // part[1], (part[0] + 1) * m1 // part[1])
    L = bkey_hat.shape[-2]
    dev = bkey_hat.device
    plan = ctx.plan_Q
    hat = torch.empty((n, len(keep), 2, L, r1 - r0, m2), dtype=torch.int32, device=dev)
    chunk = max(1, KEY_CHUNK_BYTES // (len(keep) * 2 * L * m1 * m2 * 8))
    rows = torch.as_tensor(keep, device=dev)
    for i in range(0, n, chunk):
        c = slice(i, min(n, i + chunk))
        coeffs = ntt_mod.ntt_inv(plan, mm.u32(bkey_hat[c].index_select(1, rows)))
        h = fwd_full(rplan.dplan, coeffs.reshape(coeffs.shape[:-1] + (m1, m2)))
        hat[c] = h[..., r0:r1, :].to(torch.int32)
    return hat


def _monomial_mul_dist(mono, mono_s, p, x, u):
    """Hat-domain multiply by x^u via the bit ladder on a local hat slice.
    mono: (nbits, L, m1_loc, m2); x: (B, ..., L, m1_loc, m2); u: (B,)."""
    nbits = mono.shape[0]
    cond_shape = u.shape + (1,) * (x.dim() - u.dim())
    for b in range(nbits):
        y = mm.shoup_mul(x, mono[b], mono_s[b], p)
        bit = ((u >> b) & 1).bool().reshape(cond_shape)
        x = torch.where(bit, y, x)
    return x


def blind_rotate_dist(params, ctx, rplan: DistRotationPlan, mesh, bkey_dist,
                      ua, a0, b0, axis: str = "tp", seed2=None, prune: int = 0):
    """The n-step blind rotation with the hat axis split over the mesh's
    `axis`.

    bkey_dist: (n_steps, 2(l-prune), 2, L, m1/D, m2), this rank's rows of
    the dist-hat key (`bkey_to_dist` with the same `prune` and
    part=(idx, D); at D = 1 the whole key). ua: (B, n_steps) exponents mod 2m; a0, b0: (B, L, m)
    coefficient-domain accumulators, whole on every rank (the flat layout of
    models/bootstrap.blind_rotate); seed2: None or the two Threefry key
    words, used as given. Returns (a_acc, b_acc), whole (B, L, m) on every
    rank, bit-identical to the single-device rotation."""
    n_steps = bkey_dist.shape[0]
    lk = params.num_digits - prune  # kept digits per operand
    assert bkey_dist.shape[1] == 2 * lk, (
        f"key has {bkey_dist.shape[1]} gadget rows; prune={prune} needs "
        f"{2 * lk} (use bkey_to_dist(..., prune={prune}))"
    )
    bs.check_prune(params, prune)
    L = params.num_limbs
    m1, m2 = rplan.m1, rplan.m2
    m = m1 * m2
    assert m == params.m, (m, params.m)
    group = mesh.get_group(axis)
    D = dist.get_world_size(group)
    idx = dist.get_rank(group)
    assert m1 % D == 0 and m2 % D == 0, (m1, m2, D)
    m1l, m2l = m1 // D, m2 // D
    rows = slice(idx * m1l, (idx + 1) * m1l)
    assert bkey_dist.shape[-2] == m1l, f"key rows {bkey_dist.shape[-2]}, this rank's: {m1l}"
    dplan = rplan.dplan
    p3 = dplan.plan1.p[..., None]  # (L, 1, 1)
    mono, mono_s = rplan.mono[..., rows, :], rplan.mono_s[..., rows, :]
    w = ctx.rns.w_val[prune:, :, 0].reshape(1, 1, lk, L, 1, 1)
    B = ua.shape[0]
    dev = a0.device
    a = a0.reshape(B, L, m1, m2)[..., idx * m2l:(idx + 1) * m2l]
    b = b0.reshape(B, L, m1, m2)[..., idx * m2l:(idx + 1) * m2l]
    c0 = None
    if seed2 is not None:
        # the GLOBAL counter gate*m + i1*m2 + idx*m2_loc + j of each local coefficient
        g = torch.arange(B, device=dev)[:, None, None] * m
        i1 = torch.arange(m1, device=dev)[None, :, None] * m2
        j = torch.arange(m2l, device=dev)[None, None, :] + idx * m2l
        c0 = (g + i1 + j).reshape(B, m1 * m2l)

    for k in range(n_steps):
        flat = torch.stack([a, b]).reshape(2, B, L, m1 * m2l)
        if seed2 is None:
            d = rns_mod.flatten(ctx.rns, flat, prune)
        else:
            d = rns_mod.flatten_random(ctx.rns, flat, params.moduli, seed2, k, op=(0, 1),
                                       prune=prune, c0=c0)
        # (2, B, lk, L, M) -> (B, 2lk, L, m1, m2l): a's digits, then b's
        digits = d.movedim(0, 1).reshape(B, 2 * lk, L, m1, m2l)
        x = nd.fwd_local_dyn(dplan, digits, idx, m2l)
        d_hat = nd.fwd_finish(dplan, nd.exchange_to_rows(x, group, D))  # (B, 2lk, L, m1l, m2)
        ck = mm.u32(bkey_dist[k])  # (2lk, 2, L, m1l, m2)
        s = torch.remainder(d_hat[:, :, None] * ck, p3).sum(1).remainder(p3)  # (B, 2, L, ...)
        t = torch.remainder(d_hat.reshape(B, 2, lk, L, m1l, m2) * w, p3).sum(2).remainder(p3)
        rot = _monomial_mul_dist(mono, mono_s, p3, s, ua[:, k])
        val = torch.remainder(rot - s + t, p3)
        y = nd.exchange_to_cols(nd.inv_start(dplan, val), group, D)
        back = nd.inv_finish_dyn(dplan, y, idx, m2l)  # (B, 2, L, m1, m2l)
        a, b = back[:, 0], back[:, 1]
    whole = nd.gather_cols(torch.stack([a, b]), group, D)  # (2, B, L, m1, m2)
    return whole[0].reshape(B, L, m), whole[1].reshape(B, L, m)


def _rotation(params, ctx, rplan, mesh, bkey_dist, axis):
    """blind_rotate_dist as the `rotate` of models/bootstrap.bootstrap_internal
    and models/bootstrap2._rotate_extract."""
    return functools.partial(blind_rotate_dist, params, ctx, rplan, mesh, bkey_dist,
                             axis=axis)


def bootstrap_internal_dist(params, ctx, rplan, mesh, bkey_dist, a1, b1, a2, b2,
                            axis: str = "tp", seed2=None, prune: int = 0):
    """Gate bootstrap (blind rotation + AND/OR/XOR extraction) on the
    tp-split rotation: models/bootstrap.bootstrap_internal with the key
    spanning the mesh (reference src/fhe.jl:559-595). seed2 used as given.
    Returns three LWEs over Q as ((B, L, n), (B, L)) pairs."""
    return bs.bootstrap_internal(params, ctx, None, None, a1, b1, a2, b2, seed2, prune,
                                 rotate=_rotation(params, ctx, rplan, mesh, bkey_dist, axis))


def bootstrap_batch_tp(params, ctx, rplan, mesh, bkey_dist, lwe1, lwe2, axis: str = "tp",
                       seed_words=None, epoch: "int | None" = None, prune: int = 0):
    """Batched scheme-1 gate bootstrap over the tp-split rotation, returning
    (AND, OR, XOR) LWE batches mod r: the tensor-parallel twin of
    models/bootstrap.bootstrap_batch (reference src/fhe.jl:559-621), equal
    to it bit for bit at the same seed words and epoch. seed_words: None
    or two uint32 words, with a fresh epoch folded in per call unless
    `epoch` pins it (ops/prg.fold_epoch)."""
    triple = bootstrap_internal_dist(
        params, ctx, rplan, mesh, bkey_dist, lwe1.a, lwe1.b, lwe2.a, lwe2.b, axis=axis,
        seed2=prg.fold_epoch(seed_words, epoch), prune=prune,
    )
    return tuple(bs._reduce_lwe(params, ctx, t) for t in triple)


def rotate_extract_dist(params, ctx, rplan, mesh, bkey_dist, ua, ub, t0, axis: str = "tp",
                        seed2=None, prune: int = 0) -> LWE:
    """Scheme-2 functional rotate-and-extract on the tp-split rotation
    (models/bootstrap2._rotate_extract): rotate each lane's NTT-domain test
    vector t0 (M, L, m) by its phase, extract coefficient 0, exact Q -> r
    switch."""
    return bs2._rotate_extract(params, ctx, None, None, ua, ub, t0, seed2, prune,
                               rotate=_rotation(params, ctx, rplan, mesh, bkey_dist, axis))


def bootstrap2_dist(params, ctx, rplan, mesh, bkey_dist, lwe_u, t_hats, axis: str = "tp",
                    seed_words=None, epoch: "int | None" = None, prune: int = 0) -> LWE:
    """Scheme-2 functional bootstrap over the tp-split rotation: F functions
    of each phase of lwe_u in B·F gate-major lanes
    (models/bootstrap2.bootstrap with the key spanning the mesh), equal to
    it bit for bit at the same seed words and epoch. Returns (B, F, n) /
    (B, F)."""
    return bs2.bootstrap_internal(
        params, ctx, None, None, lwe_u, t_hats, prg.fold_epoch(seed_words, epoch), prune,
        rotate=_rotation(params, ctx, rplan, mesh, bkey_dist, axis),
    )


def add_with_carry_dist(params, ctx, rplan, mesh, bkey_dist, lwe1, lwe2, carry=None,
                        axis: str = "tp", seed_words=None, epoch: "int | None" = None,
                        prune: int = 0):
    """k-bit add-with-carry through the tp-split rotation: one rotation
    pass, digit and carry as adjacent lanes (models/bootstrap2.add_with_carry)."""
    return bs2._add_with_carry(
        params, ctx, None, lwe1, lwe2, carry, prg.fold_epoch(seed_words, epoch), prune,
        rotate=_rotation(params, ctx, rplan, mesh, bkey_dist, axis),
    )
