"""Scheme 2: k-bit message FHE (Case/Gao/Hu/Xu, eprint 2019/521);
counterpart of sgfhe_tpu/models/scheme2.py (reference src/fhe2.jl +
src/rns.jl).

Parameters, context, keys, private and public encryption and decryption.
The bootstrap key's rows, public-key encryption's draws-taking core and its
q -> r switch are scheme 1's (models/scheme1.py), with scheme 2's noise
bound and bit widths. The functional bootstrap that consumes the bootstrap
key is models/bootstrap2.py. `Params` is a copy of the JAX package's (pure
Python) and must equal it field for field (tests/test_torch_scheme2.py).

Parameter deviations from the reference (documented, value-preserving):
 - Q: the reference takes Q = B*Bp for two ~34-bit primes
   (src/fhe2.jl:57-60). Here Q >= (the reference's Bp lower bound)^2 is a
   product of balanced NTT-friendly primes < 2^29, the RNS and mixed-radix
   machinery of scheme 1.
 - q: for k >= 2 (and k = 1 at n = 1024) the reference's
   q = find_modulus(2n, 2^7 r n) passes 2^27, so q becomes a product of
   NTT-friendly primes < 2^28 with the same lower bound, switched to r by
   the exact RNS rescale; a single-prime q (the toy n = 64) takes
   `modmath.rescale`.

Entry points that create tensors take `device` ("cuda" unless the caller
names another, scheme1.resolve_device); randomness comes from an explicit
`torch.Generator`, and each entry that draws has an internal function that
takes its draws as given.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from ..ops import fused as fused_mod
from ..ops import ntt as ntt_mod
from ..ops import poly as pol
from ..ops import rns as rns_mod
from ..utils import primes as pr
from ..utils import prng
from ..utils import progress
from . import scheme1 as s1


@dataclasses.dataclass(frozen=True)
class Params:
    """Reference src/fhe2.jl:17-71, `Params(k)`."""

    n: int
    k: int
    r: int
    m: int
    t: int
    q_moduli: tuple[int, ...]
    tau: int
    moduli: tuple[int, ...]  # RNS primes for Q
    Dr: int
    Dq: int

    @classmethod
    def create(cls, k: int, n: int | None = None) -> "Params":
        """Paper §6.1 parameter sets: k in 1..5, n = 2^10.

        `n` may be a smaller power of four (so that sqrt(n), and with it r,
        stays a power of two) for fast tests; the paper's security analysis
        assumes n >= 1024."""
        assert 1 <= k <= 5, "paper provides parameter sets for k in 1..5"
        if n is None:
            n = 2**10
        sqrt_n = math.isqrt(n)
        assert sqrt_n * sqrt_n == n and sqrt_n & (sqrt_n - 1) == 0 and n >= 64, (
            "n must be a power of four >= 64 (sqrt(n) enters r's derivation)"
        )
        r = 2 ** (k + 6) * sqrt_n
        m = r // 2
        l = 2  # the reference's decomposition length (noise-bound input only)
        t = math.ceil(math.log2(r)) - 1

        q_min = 2**7 * r * n
        if q_min < (1 << 27):
            q_moduli = (pr.find_modulus(2 * n, q_min),)
        else:
            count = max(2, math.ceil(q_min.bit_length() / 27))
            q_moduli = pr.find_rns_primes(2 * n, q_min, q_min * 2, count, limit=1 << 28)

        tau = 2 * sqrt_n
        bound = 15 * 2 ** (2 * k + 2) * r * tau * math.isqrt(2 * l * m)
        qmin_Q = bound * bound
        count_Q = max(2, math.ceil(qmin_Q.bit_length() / 28))
        moduli = pr.find_rns_primes(2 * m, qmin_Q, qmin_Q * 2, count_Q)

        q = 1
        for p in q_moduli:
            q *= p
        return cls(
            n=n, k=k, r=r, m=m, t=t, q_moduli=q_moduli, tau=tau,
            moduli=moduli, Dr=r // 2 ** (k + 2), Dq=q // 2 ** (k + 2),
        )

    @property
    def q(self) -> int:
        return math.prod(self.q_moduli)

    @property
    def Q(self) -> int:
        return math.prod(self.moduli)

    @property
    def DQ(self) -> int:
        return self.Q // 2 ** (self.k + 2)

    @property
    def num_limbs(self) -> int:
        return len(self.moduli)

    @property
    def num_digits(self) -> int:
        return len(self.moduli)

    @property
    def mask_r(self) -> int:
        return self.r - 1


@dataclasses.dataclass(frozen=True)
class Scheme2Context:
    plan_Q: ntt_mod.NttPlan        # length-m NTT over Q's primes
    plan_q: ntt_mod.NttPlan        # length-n NTT over q's primes
    rns_Q: rns_mod.RnsContext
    rns_q: rns_mod.RnsContext
    fused: fused_mod.FusedTables   # the rotation kernels' tables

    @property
    def rns(self) -> rns_mod.RnsContext:
        """Alias under scheme 1's name, so that the shared rotation
        (models/bootstrap.blind_rotate, ops/fused) takes this context."""
        return self.rns_Q

    @property
    def device(self) -> torch.device:
        return self.plan_Q.p.device


def make_context(params: Params, device=None) -> Scheme2Context:
    dev = s1.resolve_device(device)
    progress.log(
        f"Scheme2 make_context k={params.k} n={params.n}: building NTT/RNS tables "
        f"(m={params.m}, L={params.num_limbs}) on {s1._where(dev)}"
    )
    return Scheme2Context(
        plan_Q=ntt_mod.build_plan(params.moduli, params.m, dev),
        plan_q=ntt_mod.build_plan(params.q_moduli, params.n, dev),
        rns_Q=rns_mod.build_context(params.moduli).device_context(dev),
        rns_q=rns_mod.build_context(params.q_moduli).device_context(dev),
        fused=fused_mod.build_fused(params.moduli, params.m, dev),
    )


@dataclasses.dataclass
class PrivateKey:
    params: Params
    key: torch.Tensor  # (n,) int64 bits

    @classmethod
    def create(cls, params: Params, generator: torch.Generator,
               device=None) -> "PrivateKey":
        dev = s1.resolve_device(device)
        return cls(params, s1._draw(generator, 0, 2, (params.n,), dev))


@dataclasses.dataclass
class PublicKey:
    """(k0, k1 = k0·s + e) over q's primes (reference src/fhe2.jl:134-156):
    (Lq, n) residue stacks."""

    params: Params
    k0: torch.Tensor
    k1: torch.Tensor

    @classmethod
    def create(cls, ctx: Scheme2Context, sk: PrivateKey,
               generator: torch.Generator) -> "PublicKey":
        params = sk.params
        dev = sk.key.device
        n = params.n
        k0 = s1._uniform_residues(generator, (len(params.q_moduli), n), params.q_moduli, dev)
        # e_max: the largest integer strictly below Dq / (512 n)
        dq, rr = divmod(params.Dq, 512 * n)
        e_max = dq - (1 if rr == 0 else 0)
        e = s1._draw(generator, -e_max, e_max + 1, (1, n), dev)
        return cls(params, k0, s1._pubkey_k1(ctx, sk.key, k0, e))


@dataclasses.dataclass
class BootstrapKey:
    """GSW encryptions of the key bits with noise ±tau, the rows of scheme
    1's key (reference src/fhe2.jl:104-131), in the hat domain with Shoup
    companions: hat / hat_shoup (n, 2l, 2, L, m) int32 holding uint32
    values, built in chunks of key indices (scheme1._bootstrap_key). The
    a-column is drawn from `seed` on stream 2, the JAX package's chunked
    draw (scheme1._a_column), whatever the builder's own chunks."""

    params: Params
    hat: torch.Tensor
    hat_shoup: torch.Tensor
    seed: "np.ndarray | None" = None

    @classmethod
    def create(cls, ctx: Scheme2Context, sk: PrivateKey,
               generator: torch.Generator) -> "BootstrapKey":
        params = sk.params
        seed = s1._draw_seed(generator)
        return cls(params, *s1._bootstrap_key(params, ctx, sk.key, generator, params.tau,
                                              seed, 2), seed=seed)

    @classmethod
    def from_seeded(cls, params: Params, ctx: Scheme2Context, seed,
                    b_hat: torch.Tensor) -> "BootstrapKey":
        """The key from its seed and b-column, as scheme 1's
        `BootstrapKey.from_seeded`, on stream 2."""
        seed = np.asarray(seed, dtype=np.uint32)
        return cls(params, *s1._seeded_key(params, ctx, seed, b_hat, 2), seed=seed)


def deterministic_expand(params: Params, u: torch.Tensor) -> torch.Tensor:
    """Expand seed bits u into a mod-r polynomial (utils/prng.py)."""
    return prng.prng_expand(u, params.t + 1)


def encrypt(key_obj, *args):
    """k-bit digit encryption (reference src/fhe2.jl:165-210) -> (a, b)
    polynomials mod r:

        encrypt(sk, generator, message)       # PrivateKey
        encrypt(pk, ctx, generator, message)  # PublicKey

    Messages: (n,) ints in [0, 2^k)."""
    if isinstance(key_obj, PrivateKey):
        return _encrypt_private(key_obj, *args)
    if isinstance(key_obj, PublicKey):
        return _encrypt_public(key_obj, *args)
    raise TypeError(type(key_obj))


def _encrypt_private(sk: PrivateKey, generator: torch.Generator, message):
    params = sk.params
    dev = sk.key.device
    u = s1._draw(generator, 0, 2, (params.n,), dev)
    w_range = params.Dr // 8
    w = s1._draw(generator, -w_range, w_range + 1, (params.n,), dev)
    message = torch.as_tensor(message, device=dev).to(torch.int64)
    return _encrypt_private_draws(params, sk.key, deterministic_expand(params, u), w, message)


def _encrypt_private_draws(params: Params, s_bits, a, w, message):
    """b = a·s + w + message·Dr mod r, kept to its top k + 5 bits."""
    b = pol.negacyclic_mul_bits(a, s_bits, params.mask_r, params.q_moduli)
    b = (b + w + message * params.Dr) & params.mask_r
    shift = params.t - params.k - 4
    return a, (b >> shift) << shift


def _encrypt_public(pk: PublicKey, ctx: Scheme2Context, generator: torch.Generator,
                    message):
    params = pk.params
    dev = pk.k0.device
    n = params.n
    w1_max = params.Dq // (64 * n)
    w2_max = params.Dq // 512
    u = s1._draw(generator, -1, 2, (1, n), dev)
    w1 = s1._draw(generator, -w1_max, w1_max + 1, (1, n), dev)
    w2 = s1._draw(generator, -w2_max, w2_max + 1, (1, n), dev)
    message = torch.as_tensor(message, device=dev).to(torch.int64)
    # scheme 1's encryption with b kept to its top k + 6 bits (reference
    # src/fhe2.jl:202-207)
    rlwe = s1._encrypt_public_draws(params, ctx, pk.k0, pk.k1, u, w1, w2, message,
                                    params.k + 6)
    return rlwe.a, rlwe.b


def decrypt(sk: PrivateKey, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Reference src/fhe2.jl:213-236; returns (n,) ints in [0, 2^k)."""
    params = sk.params
    mask = params.mask_r
    sa = pol.negacyclic_mul_bits(a, sk.key, mask, params.q_moduli)
    snapped = (((b - sa) & mask) + params.Dr // 2) & mask
    return snapped // params.Dr


# The functional bootstrap and the wide integers, served from this module
# as the JAX package's scheme-2 module serves them (lazily: both import
# this module).
_BOOTSTRAP2_EXPORTS = frozenset({
    "bootstrap", "add_with_carry", "mul", "apply_lut", "refresh",
    "split_ciphertext", "decrypt_lwe", "lwe_phase_noise", "make_table", "tables_hat",
})


def __getattr__(name: str):
    if name in _BOOTSTRAP2_EXPORTS:
        from . import bootstrap2

        return getattr(bootstrap2, name)
    if name == "wideint":
        from . import wideint

        return wideint
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
