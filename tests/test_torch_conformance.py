"""Conformance of the port's gate bootstrap against the exact big-int golden
model (sgfhe_tpu/refimpl/golden.py, numpy and Params only), as
tests/test_conformance.py holds the JAX package to it: on a port-made key
at Params(64), the blind rotation's three LWEs over Q and the reduced mod-r
LWEs of the port's plain path equal the golden model's bit for bit on
two gates, and decrypt to the truth tables. The two share only `Params`:
NTT with Shoup against split matmul, the RNS mixed-radix flatten against
positional big-int divmod, the exact RNS switch against big-int rounding."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# The twins issue many small ops: one thread each, or the parallel test
# workers oversubscribe the cores and run many times slower.
torch.set_num_threads(1)

import sgfhe_tpu as F  # noqa: E402
from sgfhe_tpu.refimpl.golden import GoldenScheme  # noqa: E402

import sgfhe_tpu_torch as T  # noqa: E402
from sgfhe_tpu_torch.models import bootstrap as tbs  # noqa: E402
from sgfhe_tpu_torch.ops import modmath as mm  # noqa: E402
from sgfhe_tpu_torch.ops import ntt as tntt  # noqa: E402

GATES = 2  # the golden model's big-int rotation is slow: two gates fit the time budget


def test_port_bootstrap_matches_golden():
    params = T.Params.create(64)
    ctx = T.make_context(params, device="cpu")
    g = torch.Generator().manual_seed(2024)
    sk = T.PrivateKey.create(params, g, device="cpu")
    bkey = T.BootstrapKey.create(ctx, sk, g)
    msg = torch.randint(0, 2, (params.n,), generator=g)
    msg[:4] = torch.tensor([0, 1, 1, 1])  # gates (0, 1) and (1, 1)
    bits = T.split_ciphertext(T.encrypt(sk, g, msg)).lwe
    a1, b1 = bits.a[0:2 * GATES:2], bits.b[0:2 * GATES:2]
    a2, b2 = bits.a[1:2 * GATES:2], bits.b[1:2 * GATES:2]

    dev = tbs.bootstrap_internal(params, ctx, bkey.hat, bkey.hat_shoup, a1, b1, a2, b2)
    out = T.bootstrap_batch(params, ctx, bkey.hat, bkey.hat_shoup, T.LWE(a1, b1), T.LWE(a2, b2))

    gold = GoldenScheme(F.Params.create(64))
    c_coeff = tntt.ntt_inv(ctx.plan_Q, mm.u32(bkey.hat)).numpy().astype(np.uint64)
    s_bits = sk.key.numpy()
    y1, y2 = msg[0:2 * GATES:2].bool().numpy(), msg[1:2 * GATES:2].bool().numpy()
    for i in range(GATES):
        want = gold.bootstrap_internal(c_coeff, a1[i].numpy(), int(b1[i]), a2[i].numpy(),
                                       int(b2[i]))
        for name, (da, db), (ga, gb), lwe, truth in zip(
                ("AND", "OR", "XOR"), dev, want, out, (y1 & y2, y1 | y2, y1 ^ y2)):
            assert gold.from_rns(da[i].numpy().astype(np.uint64)) == [int(v) for v in ga], name
            assert gold.from_rns(db[i].numpy().astype(np.uint64).reshape(-1, 1))[0] == int(gb), \
                name
            ra, rb = gold.reduce_lwe_to_r((ga, gb))
            np.testing.assert_array_equal(lwe.a[i].numpy(), np.array(ra), err_msg=name)
            assert int(lwe.b[i]) == int(rb), name
            assert gold.decrypt_lwe(s_bits, ra, rb) == int(truth[i]), name
