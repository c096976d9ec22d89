"""Seeded bootstrap-key frames across the packages on the CPU: a key of
either scheme made by the JAX package regenerates bit for bit in the port
from its seed and b-column, and a key made by the port in the JAX package
(scheme 1 at Params(64), scheme 2 at k = 1, n = 64, one 128-index chunk
of stream 2; the chunk chain itself is tests/test_torch_prng.py)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# The twins issue many small ops: one thread each, or the parallel test
# workers oversubscribe the cores and run many times slower.
torch.set_num_threads(1)

import jax  # noqa: E402

import sgfhe_tpu as F  # noqa: E402
from sgfhe_tpu import serialize as RS  # noqa: E402
from sgfhe_tpu.models import scheme2 as rs2  # noqa: E402

import sgfhe_tpu_torch as T  # noqa: E402
from sgfhe_tpu_torch import interop  # noqa: E402
from sgfhe_tpu_torch import serialize as TS  # noqa: E402
from sgfhe_tpu_torch.models import scheme1 as ts1  # noqa: E402
from sgfhe_tpu_torch.models import scheme2 as ts2  # noqa: E402


def _eq(ref, got):
    np.testing.assert_array_equal(np.asarray(ref), interop.to_numpy(got))


@pytest.fixture(scope="module")
def ref64():
    """Reference keys at Params(64); the bootstrap key from jax.random.key(5)."""
    params = F.Params.create(64)
    ctx = F.make_context(params)
    sk = F.PrivateKey.create(params, jax.random.key(1))
    return dict(params=params, ctx=ctx, bkey=F.BootstrapKey.create(ctx, sk, jax.random.key(5)),
                tctx=T.make_context(params, device="cpu"))


@pytest.fixture(scope="module")
def toy2():
    """Scheme 2 at k = 1, n = 64: a reference key and the port's context."""
    params = rs2.Params.create(1, n=64)
    ctx = rs2.make_context(params)
    sk = rs2.PrivateKey.create(params, jax.random.key(2))
    tp = interop.scheme2_params(params)
    return dict(ctx=ctx, bkey=rs2.BootstrapKey.create(ctx, sk, jax.random.key(7)),
                tp=tp, tctx=ts2.make_context(tp, device="cpu"))


def test_scheme1_seeded_key_both_ways(ref64):
    params, bkey, tctx = ref64["params"], ref64["bkey"], ref64["tctx"]
    raw = RS.bootstrap_key_to_wire_seeded(bkey)
    got = TS.from_wire(raw, tctx)
    _eq(bkey.hat, got.hat)
    _eq(bkey.hat_shoup, got.hat_shoup)
    np.testing.assert_array_equal(got.seed, bkey.seed)
    assert TS.bootstrap_key_to_wire_seeded(got) == raw
    # without a context, one is built from the frame's parameters
    _eq(bkey.hat, TS.from_wire(raw, device="cpu").hat)
    # a port key through the reference
    g = torch.Generator().manual_seed(3)
    tsk = T.PrivateKey.create(params, g, device="cpu")
    tbk = T.BootstrapKey.create(tctx, tsk, g)
    back = RS.from_wire(TS.bootstrap_key_to_wire_seeded(tbk), ref64["ctx"])
    _eq(back.hat, tbk.hat)
    _eq(back.hat_shoup, tbk.hat_shoup)


def test_scheme2_seeded_key_both_ways(toy2, monkeypatch):
    bkey, tctx, tp = toy2["bkey"], toy2["tctx"], toy2["tp"]
    got = TS.from_wire(RS.bootstrap_key_to_wire_seeded(bkey), tctx)
    _eq(bkey.hat, got.hat)
    _eq(bkey.hat_shoup, got.hat_shoup)
    # a port key built in chunks of 24 key indices draws the same stream
    row_bytes = 2 * tp.num_digits * 2 * tp.num_limbs * tp.m * 8
    monkeypatch.setattr(ts1, "KEY_CHUNK_BYTES", 24 * row_bytes)
    g = torch.Generator().manual_seed(4)
    tsk = ts2.PrivateKey.create(tp, g, device="cpu")
    tbk = ts2.BootstrapKey.create(tctx, tsk, g)
    back = RS.from_wire(TS.bootstrap_key_to_wire_seeded(tbk), toy2["ctx"])
    _eq(back.hat, tbk.hat)
    _eq(back.hat_shoup, tbk.hat_shoup)
