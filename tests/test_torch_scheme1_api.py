"""The rest of the port's scheme-1 API against the JAX package on the CPU:
the exact single-prime switches (`modmath.rescale`, `rns.rescale_wide`)
against Python-int oracles, bit packing, public keys and
public-key encryption from the reference's own draws (single-prime q below
and above 2^28, RNS q), the space-optimal encodings, and
`pack_encrypted_bits` with the length-m decryption, bit for bit on the
reference's keys (randomized, with its seed words); port-made keys
decrypt right."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# The twins issue many small ops: one thread each, or the parallel test
# workers oversubscribe the cores and run many times slower.
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import sgfhe_tpu as F  # noqa: E402
from sgfhe_tpu.models import bootstrap as rbs  # noqa: E402
from sgfhe_tpu.ops import modmath as rmm  # noqa: E402
from sgfhe_tpu.ops import rns as rrns  # noqa: E402
from sgfhe_tpu.utils import bits as rbits  # noqa: E402
from sgfhe_tpu.utils import primes as rpr  # noqa: E402

import sgfhe_tpu_torch as T  # noqa: E402
from sgfhe_tpu_torch import interop  # noqa: E402
from sgfhe_tpu_torch.models import bootstrap as tbs  # noqa: E402
from sgfhe_tpu_torch.models import scheme1 as ts1  # noqa: E402
from sgfhe_tpu_torch.ops import modmath as tmm  # noqa: E402
from sgfhe_tpu_torch.ops import rns as trns  # noqa: E402
from sgfhe_tpu_torch.utils import bits as tbits  # noqa: E402


def _eq(ref, got):
    np.testing.assert_array_equal(np.asarray(ref), interop.to_numpy(got))


def _t(x):
    return interop.tensor(np.asarray(x), "cpu")


def _signed(x):
    return torch.as_tensor(np.asarray(x).astype(np.int64))


def _u32(x):
    return jnp.asarray(np.asarray(x, dtype=np.uint32))


# ---------------------------------------------------------------------------
# modmath / rns / bits
# ---------------------------------------------------------------------------


def _boundaries(q, new_max, rng, count=48):
    """Random residues and the two values around every rounding and floor
    boundary of the switch q -> new_max."""
    xs = [int.from_bytes(rng.bytes(16), "little") % q for _ in range(count)]
    for t in rng.integers(0, new_max, 16):
        for lo in (int(t) * q // new_max, (2 * int(t) + 1) * q // (2 * new_max)):
            xs += [lo % q, (lo + 1) % q]
    return xs + [0, q - 1]


@pytest.mark.parametrize("q", [rpr.find_modulus(128, 1 << 22), rpr.find_modulus(128, 1 << 27),
                               rpr.find_modulus(128, 1 << 28), (1 << 30) + 3])
@pytest.mark.parametrize("round_result", [True, False], ids=["round", "floor"])
def test_single_prime_rescales_against_oracle_and_reference(q, round_result):
    """modmath.rescale and rns.rescale_wide for any q < 2^31 (the JAX
    package's uint32 modmath.rescale only below 2^28)."""
    rng = np.random.default_rng(q % 1000)
    for new_max in (1 << 10, 1 << 16):
        x = np.array(_boundaries(q, new_max, rng), dtype=np.int64)
        oracle = [((2 * v * new_max + q) // (2 * q) if round_result else v * new_max // q)
                  % new_max for v in x]
        ref = rrns.rescale_wide(new_max, _u32(x), q, round_result)
        got = trns.rescale_wide(new_max, torch.as_tensor(x), q, round_result)
        _eq(ref, got)
        assert got.tolist() == oracle
        got = tmm.rescale(new_max, torch.as_tensor(x), q, round_result)
        assert got.tolist() == oracle
        if q < (1 << 28):
            _eq(rmm.rescale(new_max, _u32(x), q, round_result), got)


def test_rescale_exact_floor_mode_equals_reference():
    params = F.Params.create(64)
    q = params.Q
    rng = np.random.default_rng(3)
    new_max = params.r >> (params.t - 5)
    xs = _boundaries(q, new_max, rng)
    res = np.array([[v % p for v in xs] for p in params.moduli], dtype=np.int64)
    ref = rrns.rescale_exact(rrns.build_context(params.moduli).device_context(), _u32(res),
                             new_max, params.moduli, False)
    got = trns.rescale_exact(trns.build_context(params.moduli).device_context("cpu"),
                             torch.as_tensor(res), new_max, params.moduli, False)
    _eq(ref, got)
    assert got.tolist() == [v * new_max // q % new_max for v in xs]


def test_bits_pack_unpack_equal_reference():
    rng = np.random.default_rng(5)
    x = rng.integers(0, 1 << 13, 64)
    ref = rbits.unpackbits(_u32(x), 13)
    got = tbits.unpackbits(torch.as_tensor(x), 13)
    np.testing.assert_array_equal(np.asarray(ref), got.numpy())
    assert got.dtype == torch.uint8
    _eq(rbits.packbits(ref), tbits.packbits(got))
    assert torch.equal(tbits.packbits(got), torch.as_tensor(x))


# ---------------------------------------------------------------------------
# Public keys, public-key and space-optimal encryption
# ---------------------------------------------------------------------------


def _variant(kind):
    """Params(64) with its own single-prime q, a single prime above 2^28
    (the rescale_wide switch) or a two-prime RNS q."""
    base = F.Params.create(64)
    if kind == "q-prime":
        return base
    if kind == "q-wide":
        q = rpr.find_modulus(2 * base.n, 1 << 28)
        return dataclasses.replace(base, q=q, q_moduli=(q,), Dq=q // 4)
    mods = rpr.find_rns_primes(2 * base.n, 1 << 31, 1 << 32, 2, limit=1 << 28)
    q = mods[0] * mods[1]
    return dataclasses.replace(base, q=q, q_moduli=mods, Dq=q // 4)


def _pubkey_draws(params, key):
    """The reference PublicKey.create's draws (k0, e)."""
    k_u, k_e = jax.random.split(key)
    dq, rr = divmod(params.Dq, 41 * params.n)
    e_max = dq - (1 if rr == 0 else 0)
    n, mods = params.n, params.q_factors
    if len(mods) == 1:
        k0 = jax.random.randint(k_u, (n,), 0, mods[0], dtype=jnp.int32)
        e = jax.random.randint(k_e, (n,), 0, 2 * e_max + 1, dtype=jnp.int32) - e_max
        return k0, e
    keys_u = jax.random.split(k_u, len(mods))
    k0 = jnp.stack([jax.random.randint(keys_u[i], (n,), 0, p, dtype=jnp.int32)
                    for i, p in enumerate(mods)])
    return k0, jax.random.randint(k_e, (1, n), 0, 2 * e_max + 1, dtype=jnp.int32) - e_max


def _public_draws(params, key):
    """The reference's public-key encryption draws (u, w1, w2)."""
    k_u, k_w1, k_w2 = jax.random.split(key, 3)
    n = params.n
    w1_max, w2_max = params.Dq // (41 * n), params.Dq // 82
    return (jax.random.randint(k_u, (n,), -1, 2, dtype=jnp.int32),
            jax.random.randint(k_w1, (n,), -w1_max, w1_max + 1, jnp.int32),
            jax.random.randint(k_w2, (n,), -w2_max, w2_max + 1, jnp.int32))


@pytest.mark.parametrize("kind", ["q-prime", "q-wide", "q-rns"])
def test_public_key_and_encryption_from_reference_draws(kind):
    params = _variant(kind)
    ctx = F.make_context(params)
    sk = F.PrivateKey.create(params, jax.random.key(1))
    tctx = T.make_context(params, device="cpu")
    tsk = interop.private_key(params, np.asarray(sk.key), "cpu")
    pk = F.PublicKey.create(ctx, sk, jax.random.key(2))
    k0, e = _pubkey_draws(params, jax.random.key(2))
    _eq(pk.k0, _t(k0))
    _eq(pk.k1, ts1._pubkey_k1(tctx, tsk.key, _t(k0), _signed(e)))

    msg = np.array(jax.random.bernoulli(jax.random.key(3), 0.5, (params.n,)), dtype=np.int64)
    ref = F.encrypt(pk, ctx, jax.random.key(4), jnp.asarray(msg))
    draws = [_signed(x) for x in _public_draws(params, jax.random.key(4))]
    tpk = interop.public_key(params, np.asarray(pk.k0), np.asarray(pk.k1), "cpu")
    got = ts1._encrypt_public_draws(params, tctx, tpk.k0, tpk.k1, *draws,
                                    torch.as_tensor(msg), 6)
    _eq(ref.rlwe.a, got.a)
    _eq(ref.rlwe.b, got.b)
    t_ct = T.PackedCiphertext(params, got)
    np.testing.assert_array_equal(T.decrypt(tsk, t_ct).numpy(), msg.astype(bool))
    _eq(F.decrypt(sk, ref), T.decrypt(tsk, t_ct))

    # the space-optimal public encoding of the same ciphertext, and back
    opt = F.encrypt_optimal(pk, ctx, jax.random.key(4), jnp.asarray(msg))
    np.testing.assert_array_equal(np.asarray(opt.a_bits),
                                  tbits.unpackbits(got.a, params.t + 1).numpy())
    np.testing.assert_array_equal(np.asarray(opt.b_bits),
                                  tbits.unpackbits(got.b >> (params.t - 5), 6).numpy())
    back = T.normalize_ciphertext(T.PublicEncryptedCiphertext(
        params, torch.as_tensor(np.array(opt.a_bits)), torch.as_tensor(np.array(opt.b_bits))))
    ref_back = F.normalize_ciphertext(opt)
    _eq(ref_back.rlwe.a, back.rlwe.a)
    _eq(ref_back.rlwe.b, back.rlwe.b)


def test_private_optimal_encoding_equals_reference():
    """The reference's space-optimal private ciphertext normalizes to its a
    and b: the port expands u on the reference's own stream."""
    params = F.Params.create(64)
    sk = F.PrivateKey.create(params, jax.random.key(1))
    msg = jnp.asarray(np.arange(params.n) % 3 == 0)
    opt = F.encrypt_optimal(sk, jax.random.key(5), msg)
    ref = F.normalize_ciphertext(opt)
    got = T.normalize_ciphertext(T.PrivateEncryptedCiphertext(
        params, torch.as_tensor(np.array(opt.u)), torch.as_tensor(np.array(opt.v))))
    _eq(ref.rlwe.a, got.rlwe.a)
    _eq(ref.rlwe.b, got.rlwe.b)
    _eq(F.encrypt(sk, jax.random.key(5), msg).rlwe.b, got.rlwe.b)


def test_lwe_add_sub_equal_reference_mod_r():
    """LWE + and - as in the reference (callers mask mod r)."""
    params = F.Params.create(64)
    rng = np.random.default_rng(8)
    a1, a2 = (rng.integers(0, params.r, (3, params.n)) for _ in range(2))
    b1, b2 = (rng.integers(0, params.r, 3) for _ in range(2))
    r1, r2 = F.LWE(_u32(a1), _u32(b1)), F.LWE(_u32(a2), _u32(b2))
    t1, t2 = interop.lwe(a1, b1, "cpu"), interop.lwe(a2, b2, "cpu")
    for ref, got in ((r1 + r2, t1 + t2), (r1 - r2, t1 - t2), (r2 - r1, t2 - t1)):
        assert isinstance(got, T.LWE)
        _eq(np.asarray(ref.a) & params.mask_r, got.a & params.mask_r)
        _eq(np.asarray(ref.b) & params.mask_r, got.b & params.mask_r)


# ---------------------------------------------------------------------------
# Packing, decryption of length m
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def ref_keys():
    params = F.Params.create(64)
    ctx = F.make_context(params)
    k_sk, k_bk, k_m, k_e = jax.random.split(jax.random.key(11), 4)
    sk = F.PrivateKey.create(params, k_sk)
    bkey = F.BootstrapKey.create(ctx, sk, k_bk)
    msg = np.asarray(jax.random.bernoulli(k_m, 0.5, (params.n,)))
    bits = F.split_ciphertext(F.encrypt(sk, k_e, jnp.asarray(msg)))
    return dict(params=params, ctx=ctx, sk=sk, bkey=bkey, msg=msg, bits=bits,
                tctx=T.make_context(params, device="cpu"),
                tsk=interop.private_key(params, np.asarray(sk.key), "cpu"),
                tbk=interop.bootstrap_key(params, np.asarray(bkey.hat),
                                          np.asarray(bkey.hat_shoup), "cpu"))


def test_pack_encrypted_bits_randomized_equals_reference(ref_keys):
    """Randomized mode, the reference's seed words of its bootstraps and of
    its pack stage given: both mask streams and the deterministic chain
    under them."""
    s = ref_keys
    params = s["params"]
    fk = jax.random.key(17)
    ref = rbs.pack_encrypted_bits_jit(params, s["ctx"], s["bkey"].hat, s["bkey"].hat_shoup,
                                      s["bits"].lwe, True, fk, ("none", False))
    boot, pack = (tuple(int(w) for w in rrns.seed_words(k)) for k in jax.random.split(fk))
    lwe = interop.lwe(np.asarray(s["bits"].lwe.a), np.asarray(s["bits"].lwe.b), "cpu")
    got = tbs.pack_internal(params, s["tctx"], s["tbk"].hat, s["tbk"].hat_shoup, lwe, boot,
                            pack)
    _eq(ref.a, got.a)
    _eq(ref.b, got.b)
    assert got.a.shape == (params.m,)
    dec = T.decrypt(s["tsk"], T.Ciphertext(params, got))
    np.testing.assert_array_equal(dec.numpy(), s["msg"])
    ref_ct = interop.ciphertext(params, np.asarray(ref.a), np.asarray(ref.b), "cpu")
    _eq(F.decrypt(s["sk"], F.Ciphertext(params, ref)), T.decrypt(s["tsk"], ref_ct))


def test_port_keys_public_api_and_pack():
    """Port-made keys at Params(64): a public key's ciphertexts through
    split and bootstrap_batch (truth tables), the space-optimal round trip
    for both key types, and pack_encrypted_bits in deterministic mode."""
    params = T.Params.create(64)
    ctx = T.make_context(params, device="cpu")
    g = torch.Generator().manual_seed(21)
    sk = T.PrivateKey.create(params, g, device="cpu")
    pk = T.PublicKey.create(ctx, sk, g)
    bk = T.BootstrapKey.create(ctx, sk, g)
    msg = torch.randint(0, 2, (params.n,), generator=g)
    bits = T.split_ciphertext(T.encrypt(pk, ctx, g, msg)).lwe
    gates = 4
    lwe1 = T.LWE(bits.a[0:2 * gates:2], bits.b[0:2 * gates:2])
    lwe2 = T.LWE(bits.a[1:2 * gates:2], bits.b[1:2 * gates:2])
    y1, y2 = msg[0:2 * gates:2].bool(), msg[1:2 * gates:2].bool()
    out = T.bootstrap_batch(params, ctx, bk.hat, bk.hat_shoup, lwe1, lwe2)
    for lwe, want in zip(out, (y1 & y2, y1 | y2, y1 ^ y2)):
        assert torch.equal(T.decrypt_bit(sk, T.EncryptedBit(lwe)), want)
    for key_args in ((sk,), (pk, ctx)):
        opt = T.encrypt_optimal(*key_args, g, msg)
        assert torch.equal(T.decrypt(sk, T.normalize_ciphertext(opt)), msg.bool())
    packed = T.pack_encrypted_bits(params, ctx, bk, T.EncryptedBit(bits))
    assert isinstance(packed, T.Ciphertext)
    assert torch.equal(T.decrypt(sk, packed), msg.bool())
