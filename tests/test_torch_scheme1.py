"""The port's scheme-1 context, ciphertext handling and the whole slice
(keygen -> encrypt -> split -> bootstrap_batch -> decrypt_bit) at
Params(64) on the CPU, against the JAX package: tables and split bit for
bit, port-made ciphertexts and gates decrypt-equal."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# The twins issue many small ops: one thread each, or the parallel test
# workers oversubscribe the cores and run many times slower.
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import sgfhe_tpu as F  # noqa: E402

import sgfhe_tpu_torch as T  # noqa: E402
from sgfhe_tpu_torch import interop  # noqa: E402


def _eq(ref, got):
    np.testing.assert_array_equal(np.asarray(ref), interop.to_numpy(got))


@pytest.fixture(scope="module")
def ref64():
    params = F.Params.create(64)
    ctx = F.make_context(params)
    k = jax.random.split(jax.random.key(7), 4)
    sk = F.PrivateKey.create(params, k[0])
    msg = np.asarray(jax.random.bernoulli(k[2], 0.5, (params.n,)))
    ct = F.encrypt(sk, k[3], jnp.asarray(msg))
    return params, ctx, sk, msg, ct


@pytest.fixture(scope="module")
def port64():
    """Port-made keys at Params(64) on the CPU."""
    params = T.Params.create(64)
    ctx = T.make_context(params, device="cpu")
    g = torch.Generator().manual_seed(11)
    sk = T.PrivateKey.create(params, g, device="cpu")
    bkey = T.BootstrapKey.create(ctx, sk, g)
    return params, ctx, sk, bkey, g


def test_make_context_tables_equal(ref64):
    params, ref, *_ = ref64
    got = T.make_context(params, device="cpu")
    _eq(ref.tpoly_dq, got.tpoly_dq)
    _eq(ref.tpoly_dq_hat, got.tpoly_dq_hat)
    _eq(ref.dq_tilde, got.dq_tilde)
    for r_plan, g_plan in ((ref.plan_Q, got.plan_Q), (ref.plan_q, got.plan_q)):
        assert r_plan.moduli == g_plan.moduli
        _eq(r_plan.pre_tw, g_plan.pre_tw)
        _eq(r_plan.post_tw, g_plan.post_tw)
        _eq(r_plan.mono_pow_s, g_plan.mono_pow_s)
    for r_rns, g_rns in ((ref.rns, got.rns), (ref.rns_q, got.rns_q)):
        assert r_rns.close_primes == g_rns.close_primes
        for name in ("p", "mu", "inv_pj_val", "inv_pj_shoup", "w_val", "w_shoup",
                     "s_digit", "s_mod", "offset"):
            _eq(getattr(r_rns, name), getattr(g_rns, name))


def test_reference_ciphertext_split_and_decrypt(ref64):
    params, _, sk, msg, ct = ref64
    r_bits = F.split_ciphertext(ct)
    t_sk = interop.private_key(params, np.asarray(sk.key), "cpu")
    t_ct = interop.packed_ciphertext(params, np.asarray(ct.rlwe.a), np.asarray(ct.rlwe.b), "cpu")
    t_bits = T.split_ciphertext(t_ct)
    _eq(r_bits.lwe.a, t_bits.lwe.a)
    _eq(r_bits.lwe.b, t_bits.lwe.b)
    _eq(F.decrypt_bit(sk, r_bits), T.decrypt_bit(t_sk, t_bits))
    r_lwe = interop.lwe(np.asarray(r_bits.lwe.a), np.asarray(r_bits.lwe.b), "cpu")
    _eq(F.decrypt_bit(sk, r_bits), T.decrypt_bit(t_sk, T.EncryptedBit(r_lwe)))
    np.testing.assert_array_equal(T.decrypt_bit(t_sk, t_bits).numpy(), msg)
    np.testing.assert_array_equal(T.decrypt(t_sk, t_ct).numpy(), msg)


def test_port_encrypt_reference_decrypt(ref64):
    params, _, sk, _, _ = ref64
    t_sk = interop.private_key(params, np.asarray(sk.key), "cpu")
    g = torch.Generator().manual_seed(4)
    msg = torch.randint(0, 2, (params.n,), generator=g)
    t_ct = T.encrypt(t_sk, g, msg)
    r_ct = F.PackedCiphertext(
        params, F.RLWE(jnp.asarray(interop.to_numpy(t_ct.rlwe.a)),
                       jnp.asarray(interop.to_numpy(t_ct.rlwe.b)))
    )
    np.testing.assert_array_equal(np.asarray(F.decrypt(sk, r_ct)), msg.numpy().astype(bool))


def _gate_batch(params, sk, g, gates=8):
    """`gates` gates on pairs (2i, 2i+1) of one freshly encrypted message."""
    msg = torch.randint(0, 2, (params.n,), generator=g)
    bits = T.split_ciphertext(T.encrypt(sk, g, msg))
    lwe1 = T.LWE(bits.lwe.a[0:2 * gates:2], bits.lwe.b[0:2 * gates:2])
    lwe2 = T.LWE(bits.lwe.a[1:2 * gates:2], bits.lwe.b[1:2 * gates:2])
    y1, y2 = msg[0:2 * gates:2].bool(), msg[1:2 * gates:2].bool()
    return lwe1, lwe2, (y1 & y2, y1 | y2, y1 ^ y2)


@pytest.mark.parametrize(
    "seed_words,prune", [(None, 0), ((5, 6), 0), (None, 2)],
    ids=["exact", "randomized", "prune2"],
)
def test_slice_end_to_end_truth_tables(port64, seed_words, prune):
    """Port keys -> encrypt -> split -> bootstrap_batch -> decrypt_bit."""
    params, ctx, sk, bkey, g = port64
    lwe1, lwe2, expect = _gate_batch(params, sk, g)
    out = T.bootstrap_batch(params, ctx, bkey.hat, bkey.hat_shoup, lwe1, lwe2,
                            seed_words, epoch=1, prune=prune)
    for lwe, e in zip(out, expect):
        assert torch.equal(T.decrypt_bit(sk, T.EncryptedBit(lwe)), e)
        assert lwe.a.shape == (8, params.n)


def test_epoch_folds_and_bootstrap_wrapper(port64):
    params, ctx, sk, bkey, g = port64
    lwe1, lwe2, expect = _gate_batch(params, sk, g, gates=2)
    runs = [T.bootstrap_batch(params, ctx, bkey.hat, bkey.hat_shoup, lwe1, lwe2,
                              (9, 10), epoch=e) for e in (3, 3, 4)]
    assert torch.equal(runs[0][0].a, runs[1][0].a)  # pinned epoch: same masks
    assert not torch.equal(runs[0][0].a, runs[2][0].a)  # new epoch: new masks
    one = T.bootstrap(params, ctx, bkey, T.EncryptedBit(T.LWE(lwe1.a[0], lwe1.b[0])),
                      T.EncryptedBit(T.LWE(lwe2.a[0], lwe2.b[0])))
    for bit, e in zip(one, expect):
        assert bool(T.decrypt_bit(sk, bit)) == bool(e[0])
