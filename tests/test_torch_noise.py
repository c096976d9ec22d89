"""The port's noise debugger (sgfhe_tpu_torch/debug/noise.py) against the
JAX package's (sgfhe_tpu/debug/noise.py) on the CPU, on the same
ciphertexts: port-made ones at Params(64), handed to the JAX package's
functions as numpy arrays. lwe_error and noise_budget_report on fresh and
bootstrapped LWE batches and on a single bit, rlwe_error on an encrypted
PackedCiphertext and on the length-m Ciphertext of pack_encrypted_bits."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# The twins issue many small ops: one thread each, or the parallel test
# workers oversubscribe the cores and run many times slower.
torch.set_num_threads(1)

import sgfhe_tpu as F  # noqa: E402
from sgfhe_tpu.debug import noise as rnoise  # noqa: E402

import sgfhe_tpu_torch as T  # noqa: E402
from sgfhe_tpu_torch import interop  # noqa: E402
from sgfhe_tpu_torch.debug import noise as tnoise  # noqa: E402


@pytest.fixture(scope="module")
def port64():
    """Port-made keys, a message, its bits and 32 bootstrapped gates, and
    the JAX package's view of the key."""
    params = T.Params.create(64)
    ctx = T.make_context(params, device="cpu")
    g = torch.Generator().manual_seed(21)
    sk = T.PrivateKey.create(params, g, device="cpu")
    bk = T.BootstrapKey.create(ctx, sk, g)
    msg = torch.randint(0, 2, (params.n,), generator=g)
    ct = T.encrypt(sk, g, msg)
    bits = T.split_ciphertext(ct)
    l1 = T.LWE(bits.lwe.a[0::2], bits.lwe.b[0::2])
    l2 = T.LWE(bits.lwe.a[1::2], bits.lwe.b[1::2])
    gates = T.bootstrap_batch(params, ctx, bk.hat, bk.hat_shoup, l1, l2)
    ref_sk = F.PrivateKey(F.Params.create(64), interop.to_numpy(sk.key))
    return dict(params=params, ctx=ctx, sk=sk, bk=bk, msg=msg, ct=ct, bits=bits,
                gates=gates, y=(msg[0::2] & msg[1::2], msg[0::2] | msg[1::2],
                                msg[0::2] ^ msg[1::2]), ref_sk=ref_sk)


def _ref_bit(lwe):
    return F.EncryptedBit(F.LWE(interop.to_numpy(lwe.a), interop.to_numpy(lwe.b)))


def _ref_ct(cls, ct):
    return cls(F.Params.create(64), F.RLWE(interop.to_numpy(ct.rlwe.a),
                                           interop.to_numpy(ct.rlwe.b)))


def test_lwe_error_and_report_equal_reference(port64):
    s = port64
    cases = [(s["bits"].lwe, s["msg"])] + list(zip(s["gates"], s["y"]))
    cases.append((T.LWE(s["bits"].lwe.a[3], s["bits"].lwe.b[3]), s["msg"][3]))  # one bit
    for lwe, want in cases:
        got = tnoise.lwe_error(s["sk"], T.EncryptedBit(lwe), want)
        ref = rnoise.lwe_error(s["ref_sk"], _ref_bit(lwe), want.numpy())
        np.testing.assert_array_equal(got, ref)
        assert got.dtype == np.int64 and got.shape == tuple(lwe.b.shape)
        report = tnoise.noise_budget_report(s["sk"], T.EncryptedBit(lwe), want)
        assert report == rnoise.noise_budget_report(s["ref_sk"], _ref_bit(lwe), want.numpy())
        assert report["ok"] and report["max_abs"] < report["paper_bound"]
    # a wrong expected bit is off by Dr
    err = tnoise.lwe_error(s["sk"], T.EncryptedBit(s["gates"][0]), 1 - s["y"][0])
    assert np.abs(err).min() > s["params"].Dr // 2


def test_rlwe_error_equals_reference(port64):
    """A freshly encrypted PackedCiphertext (length n) and the packed
    Ciphertext (length m) of 64 bootstrapped bits."""
    s = port64
    params = s["params"]
    got = tnoise.rlwe_error(s["sk"], s["ct"], s["msg"])
    np.testing.assert_array_equal(
        got, rnoise.rlwe_error(s["ref_sk"], _ref_ct(F.PackedCiphertext, s["ct"]), s["msg"].numpy()))
    assert np.abs(got).max() < params.Dr // 4
    g_and, _, g_xor = s["gates"]
    packed_in = T.EncryptedBit(T.LWE(torch.cat([g_and.a, g_xor.a]), torch.cat([g_and.b, g_xor.b])))
    packed = T.pack_encrypted_bits(params, s["ctx"], s["bk"], packed_in)
    want = torch.cat([s["y"][0], s["y"][2]])
    got = tnoise.rlwe_error(s["sk"], packed, want)
    assert packed.rlwe.a.shape == (params.m,) and got.shape == (params.n,)
    np.testing.assert_array_equal(
        got, rnoise.rlwe_error(s["ref_sk"], _ref_ct(F.Ciphertext, packed), want.numpy()))
    assert np.abs(got).max() < params.Dr // 2
