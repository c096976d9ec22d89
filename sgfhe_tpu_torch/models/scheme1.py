"""Scheme 1 (Gao eprint 2018/637): context, keys, ciphertext types, private
encryption and decryption (counterpart of sgfhe_tpu/models/scheme1.py).

Everything lives on one torch device. Entry points that create tensors
(`make_context`, `PrivateKey.create`) take `device`; it defaults to "cuda",
and a host without a card must pass device="cpu" explicitly. Randomness
comes from an explicit `torch.Generator`; draws are made on the generator's
device and moved to the key's, so a CPU generator gives the same keys on
any device. Residues are int64 tensors; the bootstrap key is stored as
int32 bit patterns (ops/modmath.py).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..ops import fused as fused_mod
from ..ops import modmath as mm
from ..ops import ntt as ntt_mod
from ..ops import poly as pol
from ..ops import rns as rns_mod
from ..utils import prng
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


@dataclasses.dataclass
class PackedCiphertext:
    """n bits in R_{n,r}^2 from initial encryption."""

    params: Params
    rlwe: RLWE


@dataclasses.dataclass
class EncryptedBit:
    """One or a batch of single-bit LWE ciphertexts."""

    lwe: LWE


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
class BootstrapKey:
    """NTT-domain GSW encryptions of the key bits with Shoup companions.

    hat / hat_shoup: (n, 2l, 2, L, m) int32 holding uint32 values."""

    params: Params
    hat: torch.Tensor
    hat_shoup: torch.Tensor

    @classmethod
    def create(cls, ctx: SchemeContext, sk: PrivateKey,
               generator: torch.Generator) -> "BootstrapKey":
        hat = _bkey_hat(sk.params, ctx, sk.key, generator)
        shoup = _shoup_companion(hat, ctx.plan_Q.p)
        return cls(sk.params, hat.to(torch.int32), mm.bits32(shoup))


def _shoup_companion(hat: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """floor(hat * 2^32 / p) per limb; hat (..., L, m) canonical int64."""
    return (hat << 32) // p


_KEY_CHUNK = 64  # key indices per NTT batch in _bkey_hat


def _uniform_residues(generator, shape, moduli, device):
    """Independent uniform residues mod each p_i (uniform over [0, Q))."""
    assert shape[-2] == len(moduli)
    cols = [_draw(generator, 0, p, shape[:-2] + (shape[-1],), device) for p in moduli]
    return torch.stack(cols, dim=-2)


def _bkey_hat(params: Params, ctx: SchemeContext, s_bits, generator):
    """The bootstrap key in the hat domain (reference src/fhe.jl:181-201).

    Gadget terms live on the b-column: row j < l is (a, a·s + e − s_i·w_j·s),
    row l + j is (a, a·s + e + s_i·w_j) at coefficient 0."""
    n, m, L = params.n, params.m, params.num_limbs
    l = params.num_digits
    rows = 2 * l
    plan = ctx.plan_Q
    p_vec = plan.p
    dev = ctx.device
    a = _uniform_residues(generator, (n, rows, L, m), params.moduli, dev)
    e = _draw(generator, -params.n, params.n + 1, (n, rows, 1, m), dev)
    e_mod = mm.embed_signed(e, p_vec)

    s_ext = pol.resize(s_bits, m)
    s_rns = s_ext.expand(L, m)
    s_hat = ntt_mod.ntt_fwd(plan, s_rns)
    chunks = [slice(i, i + _KEY_CHUNK) for i in range(0, n, _KEY_CHUNK)]
    b = torch.empty_like(a)
    for c in chunks:  # chunks of key indices bound the temporaries
        a_hat = ntt_mod.ntt_fwd(plan, a[c])
        b[c] = ntt_mod.ntt_inv(plan, ntt_mod.pointwise_mul(plan, a_hat, s_hat))
    b = mm.addmod(b, e_mod, p_vec)

    wv = ctx.rns.w_val[..., 0]  # (l, L)
    add0 = s_bits[:, None, None] * wv[None]  # (n, l, L)
    term = add0[..., None] * s_rns  # (n, l, L, m), < 2^30
    b[:, :l] = mm.submod(b[:, :l], term, p_vec)
    b[:, l:, :, 0] = mm.addmod(b[:, l:, :, 0], add0, p_vec[:, 0])

    hat = torch.empty((n, rows, 2, L, m), dtype=torch.int64, device=dev)
    for c in chunks:
        hat[c] = ntt_mod.ntt_fwd(plan, torch.stack([a[c], b[c]], dim=2))
    return hat


# ---------------------------------------------------------------------------
# Encryption / decryption
# ---------------------------------------------------------------------------


def deterministic_expand(params: Params, u: torch.Tensor) -> torch.Tensor:
    """Expand seed bits u into a mod-r polynomial (src/fhe.jl:304-307)."""
    return prng.prng_expand(u, params.t + 1)


def encrypt(sk: PrivateKey, generator: torch.Generator, message) -> PackedCiphertext:
    """Private-key encryption of n bits (reference src/fhe.jl:310-328)."""
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
    return PackedCiphertext(params, RLWE(a, b))


def decrypt(sk: PrivateKey, ct: PackedCiphertext) -> torch.Tensor:
    """RLWE decryption -> n bool bits (reference src/fhe.jl:471-494)."""
    params = sk.params
    mask = params.mask_r
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
