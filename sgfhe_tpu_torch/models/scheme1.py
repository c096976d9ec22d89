"""Scheme 1 (Gao eprint 2018/637): context, keys (private, public,
bootstrap), ciphertext types, private, public and space-optimal encryption
and decryption (counterpart of sgfhe_tpu/models/scheme1.py).

Everything lives on one torch device. Entry points that create tensors
(`make_context`, `PrivateKey.create`) take `device`; it defaults to "cuda",
and a host without a card must pass device="cpu" explicitly. Randomness
comes from an explicit `torch.Generator`; draws are made on the generator's
device and moved to the key's, so a CPU generator gives the same keys on
any device. Where the JAX package's draws cannot be reproduced (it draws
from `jax.random`), an internal function takes the draws as given
(`_pubkey_k1`, `_encrypt_public_draws`, `_gsw_hat`) and equals the JAX
package bit for bit on its draws. Residues are int64 tensors; the
bootstrap key is stored as int32 bit patterns (ops/modmath.py).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..ops import fused as fused_mod
from ..ops import modmath as mm
from ..ops import ntt as ntt_mod
from ..ops import poly as pol
from ..ops import prg
from ..ops import rns as rns_mod
from ..utils import bits as bits_mod
from ..utils import prng
from ..utils import progress
from .params import Params


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: "cuda" unless the caller names
    another. There is no silent CPU fallback."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "sgfhe_tpu_torch runs on a CUDA device by default and none is "
            "available; pass device='cpu' to run on the CPU"
        )
    return dev


# ---------------------------------------------------------------------------
# Context
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class SchemeContext:
    plan_Q: ntt_mod.NttPlan       # length-m NTT over the RNS moduli
    plan_q: ntt_mod.NttPlan       # length-n NTT over q's prime factor(s)
    rns: rns_mod.RnsContext       # RNS constants for Q
    rns_q: rns_mod.RnsContext     # RNS constants for q
    tpoly_dq: torch.Tensor        # (L, m): t(x) * DQ~ residues
    tpoly_dq_hat: torch.Tensor    # (L, m): its NTT
    dq_tilde: torch.Tensor        # (L, 1): DQ~ mod p_i
    fused: fused_mod.FusedTables  # the rotation kernels' tables

    @property
    def device(self) -> torch.device:
        return self.tpoly_dq.device


def make_context(params: Params, device=None) -> SchemeContext:
    dev = resolve_device(device)
    progress.log(
        f"make_context n={params.n}: building NTT/RNS tables "
        f"(m={params.m}, L={params.num_limbs}) on {_where(dev)}"
    )
    plan_Q = ntt_mod.build_plan(params.moduli, params.m, dev)
    plan_q = ntt_mod.build_plan(params.q_factors, params.n, dev)
    rctx = rns_mod.build_context(params.moduli).device_context(dev)
    rctx_q = rns_mod.build_context(params.q_factors).device_context(dev)
    # initial poly t(x) = sum_{j=-(Dr-1)}^{Dr-1} x^j, scaled by DQ~ = Q // 8
    DQt = params.Q // 8
    L, m = params.num_limbs, params.m
    coeffs = np.zeros((L, m), dtype=np.int64)
    for li, p in enumerate(params.moduli):
        coeffs[li, 0:params.Dr] = DQt % p
        coeffs[li, m - params.Dr + 1:m] = (-DQt) % p
    dqt = np.array([DQt % p for p in params.moduli], dtype=np.int64).reshape(L, 1)
    tpoly = torch.as_tensor(coeffs, device=dev)
    return SchemeContext(
        plan_Q=plan_Q,
        plan_q=plan_q,
        rns=rctx,
        rns_q=rctx_q,
        tpoly_dq=tpoly,
        tpoly_dq_hat=ntt_mod.ntt_fwd(plan_Q, tpoly),
        dq_tilde=torch.as_tensor(dqt, device=dev),
        fused=fused_mod.build_fused(params.moduli, m, dev),
    )


# ---------------------------------------------------------------------------
# Ciphertext containers
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class RLWE:
    """RLWE pair over Z_r: a, b are (..., len) int64."""

    a: torch.Tensor
    b: torch.Tensor


@dataclasses.dataclass
class LWE:
    """(Batched) LWE over Z_r: a (..., n), b (...)."""

    a: torch.Tensor
    b: torch.Tensor

    def __add__(self, other):
        return LWE(self.a + other.a, self.b + other.b)  # callers mask mod r

    def __sub__(self, other):
        return LWE(self.a - other.a, self.b - other.b)


@dataclasses.dataclass
class PackedCiphertext:
    """n bits in R_{n,r}^2 from initial encryption."""

    params: Params
    rlwe: RLWE


@dataclasses.dataclass
class Ciphertext:
    """n bits in R_{m,r}^2 from packing (pack_encrypted_bits)."""

    params: Params
    rlwe: RLWE


@dataclasses.dataclass
class EncryptedBit:
    """One or a batch of single-bit LWE ciphertexts."""

    lwe: LWE


@dataclasses.dataclass
class PrivateEncryptedCiphertext:
    """Space-optimal private encryption: 6 bits a message bit
    (reference src/fhe.jl:293-301)."""

    params: Params
    u: torch.Tensor  # (n,) uint8 seed bits
    v: torch.Tensor  # (5, n) uint8: the top 5 bits of b


@dataclasses.dataclass
class PublicEncryptedCiphertext:
    """Space-optimal public encryption: 10 + log2(n) bits a message bit
    (reference src/fhe.jl:375-383)."""

    params: Params
    a_bits: torch.Tensor  # (t+1, n) uint8
    b_bits: torch.Tensor  # (6, n) uint8: the top 6 bits of b


# ---------------------------------------------------------------------------
# Keys
# ---------------------------------------------------------------------------


def _draw(generator: torch.Generator, low: int, high: int, shape, device):
    """Uniform integers in [low, high) from `generator`, moved to `device`."""
    x = torch.randint(low, high, tuple(shape), generator=generator,
                      device=generator.device, dtype=torch.int64)
    return x.to(device)


@dataclasses.dataclass
class PrivateKey:
    """s in {0,1}^n."""

    params: Params
    key: torch.Tensor  # (n,) int64 bits

    @classmethod
    def create(cls, params: Params, generator: torch.Generator,
               device=None) -> "PrivateKey":
        dev = resolve_device(device)
        return cls(params, _draw(generator, 0, 2, (params.n,), dev))


@dataclasses.dataclass
class PublicKey:
    """(k0, k1 = k0·s + e) over Z_q (reference src/fhe.jl:146-168): (n,)
    residues when q is a single prime, (Lq, n) residue stacks over q's
    prime factors when q is RNS (params.q_moduli set)."""

    params: Params
    k0: torch.Tensor
    k1: torch.Tensor

    @classmethod
    def create(cls, ctx: SchemeContext, sk: PrivateKey,
               generator: torch.Generator) -> "PublicKey":
        params = sk.params
        dev = sk.key.device
        n, mods = params.n, params.q_factors
        # e_max: the largest integer strictly below Dq / (41 n)
        dq, rr = divmod(params.Dq, 41 * n)
        e_max = dq - (1 if rr == 0 else 0)
        if len(mods) == 1:
            k0 = _draw(generator, 0, mods[0], (n,), dev)
            e = _draw(generator, -e_max, e_max + 1, (n,), dev)
        else:
            k0 = _uniform_residues(generator, (len(mods), n), mods, dev)
            e = _draw(generator, -e_max, e_max + 1, (1, n), dev)
        return cls(params, k0, _pubkey_k1(ctx, sk.key, k0, e))


def _pubkey_k1(ctx, s_bits, k0, e):
    """k1 = k0·s + e over q's factors (ctx.plan_q), from the draws k0
    ((n,) or (Lq, n) residues) and e (signed, broadcasting against k0)."""
    plan = ctx.plan_q
    k0_q = k0.reshape(plan.num_limbs, -1)
    k1 = ntt_mod.polymul(plan, k0_q, s_bits.expand(k0_q.shape))
    return mm.addmod(k1, mm.embed_signed(e, plan.p).expand(k0_q.shape), plan.p).reshape(k0.shape)


@dataclasses.dataclass
class BootstrapKey:
    """NTT-domain GSW encryptions of the key bits with Shoup companions.

    hat / hat_shoup: (n, 2l, 2, L, m) int32 holding uint32 values. seed:
    the two uint32 words of the key the uniform a-column is drawn from
    (stream 1, `_a_column`), or None for a key loaded without one."""

    params: Params
    hat: torch.Tensor
    hat_shoup: torch.Tensor
    seed: "np.ndarray | None" = None

    @classmethod
    def create(cls, ctx: SchemeContext, sk: PrivateKey,
               generator: torch.Generator) -> "BootstrapKey":
        """Reference src/fhe.jl:181-201: noise in [-n, n]."""
        seed = _draw_seed(generator)
        return cls(sk.params, *_bootstrap_key(sk.params, ctx, sk.key, generator, sk.params.n,
                                              seed, 1), seed=seed)

    @classmethod
    def from_seeded(cls, params: Params, ctx: SchemeContext, seed,
                    b_hat: torch.Tensor) -> "BootstrapKey":
        """The key from its seed and b-column (n, 2l, L, m): the a-column
        drawn again and transformed, the companions recomputed; equal bit
        for bit to the key `create` made with that seed."""
        seed = np.asarray(seed, dtype=np.uint32)
        return cls(params, *_seeded_key(params, ctx, seed, b_hat, 1), seed=seed)


def _where(dev) -> str:
    """Where a stage runs, for the progress lines."""
    return "the card" if torch.device(dev).type == "cuda" else "the host CPU"


def _key_stage(params, stream: int, what: str):
    """The progress stage of a bootstrap-key builder."""
    name = "BootstrapKey" if stream == 1 else f"Scheme2 BootstrapKey k={params.k}"
    mb = params.n * 2 * params.num_digits * 2 * params.num_limbs * params.m * 4 >> 20
    chunks = -(-params.n // _key_chunk(params))
    return progress.stage(f"{name} {what} n={params.n} ({mb} MiB hat and {mb} MiB "
                          f"companions, {chunks} chunks)")


def _shoup_companion(hat: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """floor(hat * 2^32 / p) per limb; hat (..., L, m) canonical int64."""
    return (hat << 32) // p


#: int64 hat bytes per chunk of key indices in `_bootstrap_key`
KEY_CHUNK_BYTES = 1 << 28


def _uniform_residues(generator, shape, moduli, device):
    """Independent uniform residues mod each p_i (uniform over [0, Q))."""
    assert shape[-2] == len(moduli)
    cols = [_draw(generator, 0, p, shape[:-2] + (shape[-1],), device) for p in moduli]
    return torch.stack(cols, dim=-2)


def _draw_seed(generator: torch.Generator) -> np.ndarray:
    """Two uint32 words from `generator`: the key of a bootstrap key's
    a-column."""
    return _draw(generator, 0, 1 << 32, (2,), "cpu").numpy().astype(np.uint32)


#: Key indices a chunk of scheme 2's a-column stream (stream 2) covers:
#: chunk c draws from fold_in(seed, c), as the JAX package's
#: `BootstrapKey.KEY_CHUNK` (sgfhe_tpu/models/scheme2.py).
STREAM2_CHUNK = 128


def _a_column(params, seed: np.ndarray, start: int, stop: int, stream: int,
              device) -> torch.Tensor:
    """The uniform a-column of key indices [start, stop), (stop - start,
    2l, L, m) int64, drawn as the JAX package's
    `_uniform_residues(k, (count, 2l, L, m), moduli)` draws it from the key
    `seed`: one `split(k, L)` key a limb, `randint(0, p)` on a flat counter
    over (key index, row, coefficient). Stream 1 (scheme 1) draws all n
    indices from the seed itself; stream 2 (scheme 2) draws chunk c of
    STREAM2_CHUNK indices from fold_in(seed, c). Any [start, stop) equals
    that slice of the whole."""
    rows, m = 2 * params.num_digits, params.m
    key = torch.as_tensor(seed.astype(np.int64), device=device)
    if stream == 1:
        parts = [(key, start, stop)]
    else:
        size = min(STREAM2_CHUNK, params.n)
        parts = [(prg.key_fold_in(key, c), max(start, c * size) - c * size,
                  min(stop, (c + 1) * size) - c * size)
                 for c in range(start // size, -(-stop // size))]
    out = []
    for k, i0, i1 in parts:
        limbs = prg.key_split(k, len(params.moduli))
        out.append(torch.stack([
            prg.randint(limbs[i], (i1 - i0, rows, m), 0, p, offset=i0 * rows * m)
            for i, p in enumerate(params.moduli)], dim=-2))
    return torch.cat(out)


def _key_chunk(params) -> int:
    """Key indices a chunk of the bootstrap-key builders: at most
    KEY_CHUNK_BYTES of int64 hat."""
    per = 2 * params.num_digits * 2 * params.num_limbs * params.m * 8
    return max(1, min(params.n, KEY_CHUNK_BYTES // per))


def _bootstrap_key(params, ctx, s_bits, generator, noise: int, seed: np.ndarray,
                   stream: int):
    """The bootstrap key of either scheme, (hat, hat_shoup) int32 holding
    uint32 values: the GSW rows of `_gsw_hat` with the a-column of `seed`
    on `stream` (`_a_column`) and noise in [-noise, noise] from
    `generator`, built in chunks of key indices (`_key_chunk`), so that the
    device holds the finished int32 key and one chunk's temporaries
    (scheme 2's key at k = 5 is 16 GiB with its companions)."""
    n, m, L = params.n, params.m, params.num_limbs
    rows = 2 * params.num_digits
    dev = ctx.device
    chunk = _key_chunk(params)
    s_rns, s_hat = _key_rns(ctx, s_bits, m, L)
    hat = torch.empty((n, rows, 2, L, m), dtype=torch.int32, device=dev)
    shoup = torch.empty_like(hat)
    with _key_stage(params, stream, f"create (GSW rows and companions on {_where(dev)})"):
        for i in range(0, n, chunk):
            c = slice(i, min(n, i + chunk))
            nc = c.stop - c.start
            a = _a_column(params, seed, c.start, c.stop, stream, dev)
            e = _draw(generator, -noise, noise + 1, (nc, rows, 1, m), dev)
            h = _gsw_hat(params, ctx, s_rns, s_hat, s_bits[c], a, e)
            hat[c] = h.to(torch.int32)
            shoup[c] = mm.bits32(_shoup_companion(h, ctx.plan_Q.p))
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
    return hat, shoup


def _seeded_key(params, ctx, seed: np.ndarray, b_hat: torch.Tensor, stream: int):
    """(hat, hat_shoup) of either scheme from the a-column's seed and the
    b-column (n, 2l, L, m) of any integer dtype holding uint32 values, on
    any device: the a-column drawn again (`_a_column`) and transformed,
    then the companions, chunk by chunk on ctx's device."""
    n, m, L = params.n, params.m, params.num_limbs
    rows = 2 * params.num_digits
    dev = ctx.device
    chunk = _key_chunk(params)
    hat = torch.empty((n, rows, 2, L, m), dtype=torch.int32, device=dev)
    shoup = torch.empty_like(hat)
    with _key_stage(params, stream, f"from_seeded (a-column and companions on {_where(dev)})"):
        for i in range(0, n, chunk):
            c = slice(i, min(n, i + chunk))
            a_hat = ntt_mod.ntt_fwd(ctx.plan_Q,
                                    _a_column(params, seed, c.start, c.stop, stream, dev))
            h = torch.stack([a_hat, mm.u32(b_hat[c].to(dev))], dim=2)
            hat[c] = h.to(torch.int32)
            shoup[c] = mm.bits32(_shoup_companion(h, ctx.plan_Q.p))
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
    return hat, shoup


def _key_rns(ctx, s_bits, m: int, L: int):
    """The key extended to length m on every limb, and its NTT."""
    s_rns = pol.resize(s_bits, m).expand(L, m)
    return s_rns, ntt_mod.ntt_fwd(ctx.plan_Q, s_rns)


def _gsw_hat(params, ctx, s_rns, s_hat, s_chunk, a, e):
    """GSW encryptions of the key bits s_chunk (nc,) in the hat domain,
    (nc, 2l, 2, L, m), from their uniform a-columns a (nc, 2l, L, m) and
    signed noise e (nc, 2l, 1, m). Gadget terms live on the b-column: row
    j < l is (a, a·s + e − s_i·w_j·s), row l + j is (a, a·s + e + s_i·w_j)
    at coefficient 0. Scheme 2 builds its key with the same rows."""
    l = params.num_digits
    plan = ctx.plan_Q
    p_vec = plan.p
    b = ntt_mod.ntt_inv(plan, ntt_mod.pointwise_mul(plan, ntt_mod.ntt_fwd(plan, a), s_hat))
    b = mm.addmod(b, mm.embed_signed(e, p_vec), p_vec)
    add0 = s_chunk[:, None, None] * ctx.rns.w_val[..., 0][None]  # (nc, l, L)
    b[:, :l] = mm.submod(b[:, :l], add0[..., None] * s_rns, p_vec)  # term < 2^30
    b[:, l:, :, 0] = mm.addmod(b[:, l:, :, 0], add0, p_vec[:, 0])
    return ntt_mod.ntt_fwd(plan, torch.stack([a, b], dim=2))


# ---------------------------------------------------------------------------
# Encryption / decryption
# ---------------------------------------------------------------------------


def deterministic_expand(params: Params, u: torch.Tensor) -> torch.Tensor:
    """Expand seed bits u into a mod-r polynomial (src/fhe.jl:304-307)."""
    return prng.prng_expand(u, params.t + 1)


def _encrypt_private(sk: PrivateKey, generator: torch.Generator, message):
    """Returns (u, RLWE(a, b)) (reference src/fhe.jl:310-328)."""
    params = sk.params
    dev = sk.key.device
    message = torch.as_tensor(message, device=dev).to(torch.int64)
    u = _draw(generator, 0, 2, (params.n,), dev)
    a = deterministic_expand(params, u)
    w_range = params.Dr // 8
    w = _draw(generator, -w_range, w_range + 1, (params.n,), dev)
    b = pol.negacyclic_mul_bits(a, sk.key, params.mask_r, params.q_factors)
    b = (b + w + message * params.Dr) & params.mask_r
    shift = params.t - 4  # keep only the top 5 bits (src/fhe.jl:325)
    b = (b >> shift) << shift
    return u, RLWE(a, b)


def encrypt(key_obj, *args) -> PackedCiphertext:
    """Private- or public-key encryption of n bits, like the reference's
    `encrypt` (src/fhe.jl:369-372, 459-461):

        encrypt(sk, generator, message)       # PrivateKey
        encrypt(pk, ctx, generator, message)  # PublicKey
    """
    if isinstance(key_obj, PrivateKey):
        generator, message = args
        return PackedCiphertext(key_obj.params, _encrypt_private(key_obj, generator, message)[1])
    if isinstance(key_obj, PublicKey):
        return encrypt_public(key_obj, *args)
    raise TypeError(f"encrypt expects a PrivateKey or PublicKey, got {type(key_obj)}")


def encrypt_public(pk: PublicKey, ctx: SchemeContext, generator: torch.Generator,
                   message) -> PackedCiphertext:
    """Public-key encryption of n bits (reference src/fhe.jl:386-409)."""
    return PackedCiphertext(pk.params, _encrypt_public(pk, ctx, generator, message))


def _encrypt_public(pk: PublicKey, ctx: SchemeContext, generator, message) -> RLWE:
    params = pk.params
    dev = pk.k0.device
    n = params.n
    w1_max = params.Dq // (41 * n)
    w2_max = params.Dq // 82
    u = _draw(generator, -1, 2, (n,), dev)
    w1 = _draw(generator, -w1_max, w1_max + 1, (n,), dev)
    w2 = _draw(generator, -w2_max, w2_max + 1, (n,), dev)
    message = torch.as_tensor(message, device=dev).to(torch.int64)
    return _encrypt_public_draws(params, ctx, pk.k0, pk.k1, u, w1, w2, message, 6)


def _residues(v: int, plan) -> torch.Tensor:
    """(L, 1) residues of the Python int v modulo the plan's moduli."""
    return torch.tensor([v % p for p in plan.moduli], device=plan.p.device).reshape(-1, 1)


def _encrypt_public_draws(params, ctx, k0, k1, u, w1, w2, message, b_bits: int) -> RLWE:
    """Public-key encryption of either scheme from its draws: u in
    {-1, 0, 1}^n, the signed noises w1 and w2, messages (n,) (bits, or
    scheme 2's digits). a1 = k0·u + w1 and a2 = k1·u + w2 + message·Dq over
    q, then the exact switch q -> r: a rounds to Z_r, b floors to its top
    b_bits bits (6 in scheme 1, k + 6 in scheme 2)."""
    plan = ctx.plan_q
    p = plan.p
    shape = (plan.num_limbs, params.n)

    def to_q(x):
        return mm.embed_signed(x, p).expand(shape)

    u_q = to_q(u)
    a1 = mm.addmod(ntt_mod.polymul(plan, k0.reshape(shape), u_q), to_q(w1), p)
    a2 = mm.addmod(ntt_mod.polymul(plan, k1.reshape(shape), u_q), to_q(w2), p)
    a2 = mm.addmod(a2, mm.mulmod(message, _residues(params.Dq, plan), p), p)
    shift = params.t + 1 - b_bits
    a = _switch_q_to_r(ctx, a1, params.r, True)
    b = _switch_q_to_r(ctx, a2, params.r >> shift, False)
    return RLWE(a, b << shift)


def _switch_q_to_r(ctx, x, new_max: int, round_result: bool) -> torch.Tensor:
    """Exact modulus switch q -> new_max (a power of two; round or floor)
    of (Lq, ...) residues over q's primes (ctx.plan_q), the reference's
    `reduce_modulus` (src/utils.jl:78-127): `modmath.rescale` for a single
    prime, `rns.rescale_exact` for an RNS q."""
    moduli = ctx.plan_q.moduli
    if len(moduli) == 1:
        return mm.rescale(new_max, x[0], moduli[0], round_result)
    return rns_mod.rescale_exact(ctx.rns_q, x, new_max, moduli, round_result)


def encrypt_optimal(key_obj, *args):
    """Space-optimal encryption (reference src/fhe.jl:339-345, 420-435):

        encrypt_optimal(sk, generator, message)       -> PrivateEncryptedCiphertext
        encrypt_optimal(pk, ctx, generator, message)  -> PublicEncryptedCiphertext
    """
    if isinstance(key_obj, PrivateKey):
        params = key_obj.params
        u, rlwe = _encrypt_private(key_obj, *args)
        v = bits_mod.unpackbits(rlwe.b >> (params.t - 4), 5)
        return PrivateEncryptedCiphertext(params, u.to(torch.uint8), v)
    if isinstance(key_obj, PublicKey):
        params = key_obj.params
        rlwe = _encrypt_public(key_obj, *args)
        return PublicEncryptedCiphertext(
            params, bits_mod.unpackbits(rlwe.a, params.t + 1),
            bits_mod.unpackbits(rlwe.b >> (params.t - 5), 6),
        )
    raise TypeError(type(key_obj))


def normalize_ciphertext(ct) -> PackedCiphertext:
    """Space-optimal -> PackedCiphertext (reference src/fhe.jl:354-359,
    444-449)."""
    params = ct.params
    if isinstance(ct, PrivateEncryptedCiphertext):
        a = deterministic_expand(params, ct.u.to(torch.int64))
        b = bits_mod.packbits(ct.v) << (params.t - 4)
        return PackedCiphertext(params, RLWE(a, b))
    if isinstance(ct, PublicEncryptedCiphertext):
        a = bits_mod.packbits(ct.a_bits)
        b = bits_mod.packbits(ct.b_bits) << (params.t - 5)
        return PackedCiphertext(params, RLWE(a, b))
    raise TypeError(type(ct))


def decrypt(sk: PrivateKey, ct) -> torch.Tensor:
    """RLWE decryption -> n bool bits (reference src/fhe.jl:471-494). A
    packed `Ciphertext` lives on the length-m ring, whose helper primes are
    Q's (2m | p-1); a PackedCiphertext on the length-n ring uses q's."""
    params = sk.params
    mask = params.mask_r
    if isinstance(ct, Ciphertext):
        s = pol.resize(sk.key, params.m)
        sa = pol.negacyclic_mul_bits(ct.rlwe.a, s, mask, params.moduli)
    else:
        sa = pol.negacyclic_mul_bits(ct.rlwe.a, sk.key, mask, params.q_factors)
    b1 = ((ct.rlwe.b - sa) & mask)[..., :params.n]
    snapped = (b1 + params.Dr // 2) & mask
    return (snapped // params.Dr).bool()


def split_ciphertext(ct: PackedCiphertext) -> EncryptedBit:
    """RLWE -> n LWEs, batched as one EncryptedBit with leading axis n."""
    params = ct.params
    n = params.n
    a = ct.rlwe.a
    length = a.shape[-1]
    dev = a.device
    i_idx = torch.arange(n, device=dev)[:, None]
    k_idx = torch.arange(n, device=dev)[None, :]
    src = (i_idx - k_idx) % length
    g = a[..., src]
    g = torch.where(k_idx > i_idx, (-g) & params.mask_r, g)
    return EncryptedBit(LWE(g, ct.rlwe.b[..., :n]))


def decrypt_bit(sk: PrivateKey, enc_bit: EncryptedBit) -> torch.Tensor:
    """LWE decryption -> bool (reference src/fhe.jl:504-507); batched."""
    params = sk.params
    mask = params.mask_r
    dot = (enc_bit.lwe.a * sk.key).sum(-1)
    b1 = (enc_bit.lwe.b - dot) & mask
    return (((b1 + params.Dr // 2) & mask) // params.Dr).bool()
