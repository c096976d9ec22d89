"""The port's scheme-2 functional bootstrap (sgfhe_tpu_torch/models/
bootstrap2.py) against the JAX package on the CPU, at its toy sets k = 1
and k = 2 with n = 64, on the JAX package's keys: LWE plumbing, test
vectors, add_with_carry bit for bit in deterministic (with a carry in),
pruned (prune=1) and randomized mode (the reference's folded seed words
given), apply_lut and refresh at k = 2, mul in randomized mode (the
reference's three split seed words given); port-made keys decrypt right;
the shared rotation reads only generic Params fields."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# The twins issue many small ops: one thread each, or the parallel test
# workers oversubscribe the cores and run many times slower.
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from sgfhe_tpu.models import bootstrap2 as rb2  # noqa: E402
from sgfhe_tpu.models import params as rparams  # noqa: E402
from sgfhe_tpu.models import scheme2 as rs2  # noqa: E402
from sgfhe_tpu.models.scheme1 import LWE as RLWE1  # noqa: E402
from sgfhe_tpu.ops import rns as rrns  # noqa: E402

import sgfhe_tpu_torch as T  # noqa: E402
from sgfhe_tpu_torch import interop  # noqa: E402
from sgfhe_tpu_torch.models import bootstrap as tbs  # noqa: E402
from sgfhe_tpu_torch.models import bootstrap2 as tb2  # noqa: E402
from sgfhe_tpu_torch.models import params as tparams  # noqa: E402
from sgfhe_tpu_torch.models import scheme2 as ts2  # noqa: E402

B = 4  # pairs a call: every (x, y) of k = 1


def _eq(ref, got):
    np.testing.assert_array_equal(np.asarray(ref), interop.to_numpy(got))


def _eq_lwe(ref, got):
    _eq(ref.a, got.a)
    _eq(ref.b, got.b)


def _setup(k, seed):
    params = rs2.Params.create(k, n=64)
    ctx = rs2.make_context(params)
    sk = rs2.PrivateKey.create(params, jax.random.key(seed))
    bkey = rs2.BootstrapKey.create(ctx, sk, jax.random.key(seed + 1))
    tp = interop.scheme2_params(params)
    s = dict(params=params, ctx=ctx, sk=sk, bkey=bkey, tp=tp,
             tctx=ts2.make_context(tp, device="cpu"),
             tsk=interop.private_key(tp, np.asarray(sk.key), "cpu"),
             tbk=interop.bootstrap_key(tp, np.asarray(bkey.hat), np.asarray(bkey.hat_shoup),
                                       "cpu"))
    # inputs: x, y in [0, 2^k) (for k = 1 every pair), a carry bit c
    K = 2**k
    x = np.arange(B) // 2 % K if k == 1 else np.random.default_rng(k).integers(0, K, B)
    y = np.arange(B) % 2 if k == 1 else np.random.default_rng(k + 1).integers(0, K, B)
    c = np.array([1, 0, 1, 1])[:B]
    for name, vals, key in (("x", x, 50), ("y", y, 51), ("c", c, 52)):
        msg = np.zeros(params.n, dtype=np.int64)
        msg[:B] = vals
        a, b = rs2.encrypt(sk, jax.random.key(seed + key), jnp.asarray(msg))
        lwe = rb2.split_ciphertext(params, a, b)
        s[name] = vals
        s["r" + name] = RLWE1(lwe.a[:B], lwe.b[:B])
        s["t" + name] = interop.lwe(np.asarray(lwe.a[:B]), np.asarray(lwe.b[:B]), "cpu")
    return s


@pytest.fixture(scope="module")
def toy_k1():
    return _setup(1, 1)


@pytest.fixture(scope="module")
def toy_k2():
    return _setup(2, 3)


def _words(key, epoch):
    """The folded seed words the reference's rotation draws its masks from."""
    return tuple(int(w) for w in rrns.seed_words(jax.random.fold_in(key, epoch)))


def test_split_decrypt_noise_and_tables_equal(toy_k1, toy_k2):
    s = toy_k1
    params, tp = s["params"], s["tp"]
    a, b = rs2.encrypt(s["sk"], jax.random.key(9), jnp.arange(params.n) % 2)
    ref = rb2.split_ciphertext(params, a, b)
    got = tb2.split_ciphertext(tp, interop.tensor(np.asarray(a), "cpu"),
                               interop.tensor(np.asarray(b), "cpu"))
    _eq_lwe(ref, got)
    _eq(rb2.decrypt_lwe(s["sk"], ref), tb2.decrypt_lwe(s["tsk"], got))
    msg = np.arange(params.n) % 2
    _eq(rb2.lwe_phase_noise(s["sk"], ref, jnp.asarray(msg)).astype(jnp.uint32),
        tb2.lwe_phase_noise(s["tsk"], got, torch.as_tensor(msg)))
    for t in (toy_k1, toy_k2):
        K = 2**t["params"].k
        tables = [[z % K for z in range(2 * K)], [-(z // K) for z in range(2 * K)]]
        for f in tables:
            np.testing.assert_array_equal(rb2.make_table(t["params"], f),
                                          tb2.make_table(t["tp"], f))
        _eq(rb2.tables_hat(t["params"], t["ctx"], tables),
            tb2.tables_hat(t["tp"], t["tctx"], tables))


@pytest.mark.parametrize("mode", ["exact-carry-in", "prune1", "randomized"])
def test_add_with_carry_equals_reference(toy_k1, mode):
    s = toy_k1
    prune = 1 if mode == "prune1" else 0
    fk = jax.random.key(82) if mode == "randomized" else None
    rc, tc = (s["rc"], s["tc"]) if mode == "exact-carry-in" else (None, None)
    ref = rb2.add_with_carry(s["params"], s["ctx"], s["bkey"], s["rx"], s["ry"], rc,
                             flat_key=fk, epoch=7, prune=prune)
    seed2 = _words(fk, 7) if fk is not None else None
    got = tb2._add_with_carry(s["tp"], s["tctx"], s["tbk"], s["tx"], s["ty"], tc, seed2,
                              prune)
    for r, g in zip(ref, got):
        _eq_lwe(r, g)
    z = s["x"] + s["y"] + (s["c"] if rc is not None else 0)
    K = 2**s["tp"].k
    np.testing.assert_array_equal(tb2.decrypt_lwe(s["tsk"], got[0]).numpy(), z % K)
    np.testing.assert_array_equal(tb2.decrypt_lwe(s["tsk"], got[1]).numpy(), z // K)


def test_k2_apply_lut_and_refresh_equal_reference(toy_k2):
    s = toy_k2
    params, ctx, bkey = s["params"], s["ctx"], s["bkey"]
    tp, tctx, tbk = s["tp"], s["tctx"], s["tbk"]
    lut = [3, 1, 0, 2]
    ref = rb2.apply_lut(params, ctx, bkey, s["rx"], lut)
    got = T.Scheme2Boot.apply_lut(tp, tctx, tbk, s["tx"], lut)
    _eq_lwe(ref, got)
    np.testing.assert_array_equal(tb2.decrypt_lwe(s["tsk"], got).numpy(),
                                  np.array(lut)[s["x"]])
    ref = rb2.refresh(params, ctx, bkey, s["ry"])
    got = tb2.refresh(tp, tctx, tbk, s["ty"])
    _eq_lwe(ref, got)
    np.testing.assert_array_equal(tb2.decrypt_lwe(s["tsk"], got).numpy(), s["y"])


def test_mul_randomized_equals_reference(toy_k1):
    """Every (x, y) of k = 1 through the three rounds, each round drawing
    its masks from its own split of the folded key."""
    s = toy_k1
    fk = jax.random.key(312)
    ref = rb2.mul(s["params"], s["ctx"], s["bkey"], s["rx"], s["ry"], flat_key=fk, epoch=5)
    subkeys = jax.random.split(jax.random.fold_in(fk, 5), 3)
    seeds = [tuple(int(w) for w in rrns.seed_words(k)) for k in subkeys]
    got = tb2._mul(s["tp"], s["tctx"], s["tbk"], s["tx"], s["ty"], seeds)
    for r, g in zip(ref, got):
        _eq_lwe(r, g)
    prod = s["x"] * s["y"]
    np.testing.assert_array_equal(tb2.decrypt_lwe(s["tsk"], got[0]).numpy(), prod % 2)
    np.testing.assert_array_equal(tb2.decrypt_lwe(s["tsk"], got[1]).numpy(), prod // 2)


def test_port_keys_add_and_mul(toy_k1):
    """Port-made keys and encryptions through the public entries with
    seed words (folded per call; mul splits them per round):
    add_with_carry and mul decrypt right and stay refreshed; another epoch
    draws other masks."""
    tp, tctx = toy_k1["tp"], toy_k1["tctx"]
    g = torch.Generator().manual_seed(8)
    sk = ts2.PrivateKey.create(tp, g, device="cpu")
    bk = ts2.BootstrapKey.create(tctx, sk, g)
    x = torch.tensor([0, 0, 1, 1] + [0] * (tp.n - 4))
    y = torch.tensor([0, 1, 0, 1] + [0] * (tp.n - 4))
    lx = tb2.split_ciphertext(tp, *ts2.encrypt(sk, g, x))
    ly = tb2.split_ciphertext(tp, *ts2.encrypt(sk, g, y))
    lx, ly = T.LWE(lx.a[:B], lx.b[:B]), T.LWE(ly.a[:B], ly.b[:B])
    digit, carry = tb2.add_with_carry(tp, tctx, bk, lx, ly, seed_words=(3, 4), epoch=1)
    z = x[:B] + y[:B]
    assert torch.equal(tb2.decrypt_lwe(sk, digit), z % 2)
    assert torch.equal(tb2.decrypt_lwe(sk, carry), z // 2)
    assert tb2.lwe_phase_noise(sk, digit, z % 2).abs().max() < tp.Dr // 4
    other, _ = tb2.add_with_carry(tp, tctx, bk, lx, ly, seed_words=(3, 4), epoch=2)
    assert not torch.equal(other.a, digit.a)
    lo, hi = tb2.mul(tp, tctx, bk, lx, ly, seed_words=(5, 6))
    assert torch.equal(tb2.decrypt_lwe(sk, lo), x[:B] * y[:B])
    assert torch.equal(tb2.decrypt_lwe(sk, hi), torch.zeros(B, dtype=torch.int64))


def test_rotation_reads_generic_params_fields():
    """The shared rotation's dispatcher and prune guard take scheme-2
    Params as they are: the toy k = 1 key (4 MiB with companions) takes the
    one-launch resident kernel at every prune, the toy k = 2 (18 MiB) and
    paper k = 1 (576 MiB) keys the step pair with w-multiplies."""
    cpu, cuda = torch.device("cpu"), torch.device("cuda")
    k1, k2, paper = (ts2.Params.create(1, 64), ts2.Params.create(2, 64), ts2.Params.create(1))
    assert tbs._rotation_route(k1, cpu) == "plain"
    assert tbs._rotation_route(paper, cpu) == "plain"
    assert tbs._rotation_route(k1, cuda) == "resident"
    assert tbs._rotation_route(k2, cuda) == "wmul"
    assert tbs._rotation_route(paper, cuda) == "wmul"
    for p in (k1, k2, paper):
        ref = rs2.Params.create(p.k, p.n)
        assert tparams.prune_error_bound(p, 1) == rparams.prune_error_bound(ref, 1)
    bad = dataclasses.replace(k1, moduli=(11, 13))
    with pytest.raises(AssertionError, match="digit pruning"):
        tbs.blind_rotate(bad, None, None, None, None, None, None, prune=1)
