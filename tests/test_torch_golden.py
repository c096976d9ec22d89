"""The port's copy of the golden model (sgfhe_tpu_torch/refimpl/golden.py)
against the JAX package's (sgfhe_tpu/refimpl/golden.py) on the same seeded
numpy inputs: the exact negacyclic product, the RNS and gadget helpers, an
external product against a random key matrix, decryption of the port's
encryptions, and one whole gate on a port-made key at Params(64); then the
port's bootstrap against the port's own golden model on that gate, bit for
bit, as tests/test_torch_conformance.py holds it against the JAX
package's."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# The twins issue many small ops: one thread each, or the parallel test
# workers oversubscribe the cores and run many times slower.
torch.set_num_threads(1)

import sgfhe_tpu as F  # noqa: E402
from sgfhe_tpu.refimpl import golden as rg  # noqa: E402

import sgfhe_tpu_torch as T  # noqa: E402
from sgfhe_tpu_torch.models import bootstrap as tbs  # noqa: E402
from sgfhe_tpu_torch.ops import modmath as mm  # noqa: E402
from sgfhe_tpu_torch.ops import ntt as tntt  # noqa: E402
from sgfhe_tpu_torch.refimpl import golden as tg  # noqa: E402


@pytest.fixture(scope="module")
def pair():
    """Both golden models at Params(64), and a port-made key and
    encryption there."""
    params = T.Params.create(64)
    ctx = T.make_context(params, device="cpu")
    g = torch.Generator().manual_seed(77)
    sk = T.PrivateKey.create(params, g, device="cpu")
    bkey = T.BootstrapKey.create(ctx, sk, g)
    msg = torch.randint(0, 2, (params.n,), generator=g)
    msg[:2] = torch.tensor([1, 1])
    bits = T.split_ciphertext(T.encrypt(sk, g, msg)).lwe
    return dict(params=params, ctx=ctx, bkey=bkey, ref=rg.GoldenScheme(F.Params.create(64)),
                got=tg.GoldenScheme(params), sk=sk, msg=msg, bits=bits,
                c_coeff=tntt.ntt_inv(ctx.plan_Q, mm.u32(bkey.hat)).numpy().astype(np.uint64))


@pytest.fixture(scope="module")
def gate(pair):
    """Gate (bit 0, bit 1) = (1, 1) through both golden models (about 15 s
    each)."""
    bits = pair["bits"]
    args = (pair["c_coeff"], bits.a[0].numpy(), int(bits.b[0]), bits.a[1].numpy(),
            int(bits.b[1]))
    return pair["ref"].bootstrap_internal(*args), pair["got"].bootstrap_internal(*args)


@pytest.mark.parametrize("m", [8, 64, 512])
def test_negacyclic_mul_u64_equals_reference(m):
    rng = np.random.default_rng(m)
    for p in (12289, 134215681, (1 << 30) - 35):
        a = rng.integers(0, 1 << 40, m, dtype=np.uint64)
        b = rng.integers(0, 1 << 40, m, dtype=np.uint64)
        got = tg.negacyclic_mul_u64(a, b, p)
        np.testing.assert_array_equal(got, rg.negacyclic_mul_u64(a, b, p))
        assert got.dtype == np.uint64 and int(got.max()) < p


def test_helpers_equal_reference(pair):
    ref, got = pair["ref"], pair["got"]
    assert (got.Q, got.weights, got.s_off, got.offset) == (ref.Q, ref.weights, ref.s_off,
                                                             ref.offset)
    rng = np.random.default_rng(5)
    vals = [int(v) for v in rng.integers(0, 1 << 62, 64)] + [0, got.Q - 1, got.Q // 2]
    res = got.to_rns(vals)
    np.testing.assert_array_equal(res, ref.to_rns(vals))
    assert got.from_rns(res) == ref.from_rns(res) == [v % got.Q for v in vals]
    assert got.flatten(vals) == ref.flatten(vals)
    assert got.initial_poly_times_dq() == ref.initial_poly_times_dq()
    coeffs = vals[:got.p.m] + [0] * (got.p.m - len(vals))
    for j in (0, 1, 7, got.p.m - 1, got.p.m, 2 * got.p.m - 3, -5):
        assert got.mul_by_monomial(coeffs, j) == ref.mul_by_monomial(coeffs, j)


def test_external_product_equals_reference(pair):
    ref, got, params = pair["ref"], pair["got"], pair["params"]
    L, m = params.num_limbs, params.m
    rng = np.random.default_rng(11)
    p = np.array(params.moduli, dtype=np.uint64).reshape(L, 1)
    A = rng.integers(0, 1 << 30, (2 * L, 2, L, m), dtype=np.uint64) % p
    a = [int(v) for v in rng.integers(0, 1 << 62, m)]
    b = [int(v) for v in rng.integers(0, 1 << 62, m)]
    assert got.external_product(a, b, A) == ref.external_product(a, b, A)


def test_decrypt_of_port_encryptions_equals_reference(pair):
    ref, got, sk, bits = pair["ref"], pair["got"], pair["sk"], pair["bits"]
    s_bits = sk.key.numpy()
    for i in range(pair["params"].n):
        a, b = bits.a[i].numpy(), int(bits.b[i])
        assert got.decrypt_lwe(s_bits, a, b) == ref.decrypt_lwe(s_bits, a, b) \
            == int(pair["msg"][i])


def test_gate_equals_reference(pair, gate):
    """The three LWEs over Q, their exact switch to r and their decryption."""
    ref, got = pair["ref"], pair["got"]
    want, have = gate
    s_bits = pair["sk"].key.numpy()
    for (wa, wb), (ha, hb), truth in zip(want, have, (1, 1, 0)):
        assert [int(v) for v in ha] == [int(v) for v in wa] and int(hb) == int(wb)
        assert got.reduce_lwe_to_r((ha, hb)) == ref.reduce_lwe_to_r((wa, wb))
        assert got.decrypt_lwe(s_bits, *got.reduce_lwe_to_r((ha, hb))) == truth


def test_port_bootstrap_matches_own_golden(pair, gate):
    """The port's plain bootstrap on the same gate equals its own golden
    model bit for bit: the rotation's LWEs over Q and the LWEs mod r."""
    params, ctx, bkey, bits, got = (pair[k] for k in ("params", "ctx", "bkey", "bits", "got"))
    a1, b1, a2, b2 = bits.a[0:1], bits.b[0:1], bits.a[1:2], bits.b[1:2]
    dev = tbs.bootstrap_internal(params, ctx, bkey.hat, bkey.hat_shoup, a1, b1, a2, b2)
    out = T.bootstrap_batch(params, ctx, bkey.hat, bkey.hat_shoup, T.LWE(a1, b1),
                            T.LWE(a2, b2))
    for name, (da, db), (ga, gb), lwe in zip(("AND", "OR", "XOR"), dev, gate[1], out):
        assert got.from_rns(da[0].numpy().astype(np.uint64)) == [int(v) for v in ga], name
        assert got.from_rns(db[0].numpy().astype(np.uint64).reshape(-1, 1))[0] == int(gb), name
        ra, rb = got.reduce_lwe_to_r((ga, gb))
        np.testing.assert_array_equal(lwe.a[0].numpy(), np.array(ra), err_msg=name)
        assert int(lwe.b[0]) == int(rb), name
