"""The port's boolean-circuit layer (sgfhe_tpu_torch/circuit.py) against
the JAX package's (sgfhe_tpu/circuit.py) on the CPU: the builder wire for
wire and level for level on the stock circuits and on seeded random
circuits; evaluation at Params(64) on the JAX package's keys and
ciphertexts, bit for bit, deterministic (ripple_adder(4)) and randomized
(comparator(4), whose second level of 3 pairs is padded to 4, with the
JAX package's epoch counter pinned and each level's folded words given);
an all-constant circuit; and the public entry's epoch fold and split."""

import itertools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# The twins issue many small ops: one thread each, or the parallel test
# workers oversubscribe the cores and run many times slower.
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import sgfhe_tpu as F  # noqa: E402
from sgfhe_tpu import circuit as RC  # noqa: E402
from sgfhe_tpu.ops import prg as rprg  # noqa: E402
from sgfhe_tpu.ops import rns as rrns  # noqa: E402

import sgfhe_tpu_torch as T  # noqa: E402
from sgfhe_tpu_torch import circuit as TC  # noqa: E402
from sgfhe_tpu_torch import interop  # noqa: E402
from sgfhe_tpu_torch.ops import prg  # noqa: E402

B = 4  # instances of each circuit
STOCK = ("ripple_adder", "equality", "subtractor", "comparator", "mux")


def _structure(c):
    return ([(w.op, w.args, w.level) for w in c._wires], c._outputs, c.schedule(), c.depth,
            c.num_bootstraps, c.num_inputs, c.num_outputs)


@pytest.mark.parametrize("name", STOCK)
@pytest.mark.parametrize("nbits", [1, 3, 8, 16])
def test_stock_circuits_equal_reference(name, nbits):
    assert _structure(getattr(TC, name)(nbits)) == _structure(getattr(RC, name)(nbits))


def _random_build(mod, seed):
    """The same seeded sequence of builder calls on either package's
    Circuit: gates, NOTs and constants over earlier wires, so folding,
    CSE, complementary wires and dead gates all occur."""
    rng = np.random.default_rng(seed)
    c = mod.Circuit()
    wires = [c.input() for _ in range(4)] + [c.const(0), c.const(1)]
    ops = ("and_", "or_", "xor_", "nand", "nor", "xnor")
    for _ in range(40):
        kind = rng.integers(0, 8)
        if kind < 6:
            x, y = rng.integers(0, len(wires), 2)
            wires.append(getattr(c, ops[kind])(wires[x], wires[y]))
        else:
            wires.append(c.not_(wires[rng.integers(0, len(wires))]))
    for i in rng.choice(len(wires), 5, replace=False):
        c.output(wires[i])
    return c, rng.integers(0, 2, (8, c.num_inputs))


@pytest.mark.parametrize("seed", range(6))
def test_random_circuits_equal_reference(seed):
    (tc, bits), (rc, _) = _random_build(TC, seed), _random_build(RC, seed)
    assert _structure(tc) == _structure(rc)
    for row in bits:
        assert TC.evaluate_plain(tc, row) == RC.evaluate_plain(rc, row)


@pytest.fixture(scope="module")
def ref64():
    params = F.Params.create(64)
    ctx = F.make_context(params)
    k_sk, k_bk = jax.random.split(jax.random.key(5))
    sk = F.PrivateKey.create(params, k_sk)
    bkey = F.BootstrapKey.create(ctx, sk, k_bk)
    return dict(params=params, ctx=ctx, sk=sk, bkey=bkey,
                tctx=T.make_context(params, device="cpu"),
                tsk=interop.private_key(params, np.asarray(sk.key), "cpu"),
                tbk=interop.bootstrap_key(params, np.asarray(bkey.hat),
                                          np.asarray(bkey.hat_shoup), "cpu"))


def _inputs(s, num_inputs, seed):
    """B instances of random input bits, encrypted by the JAX package and
    carried over: (bits (num_inputs, B), reference inputs, port inputs)."""
    bits = np.random.default_rng(seed).integers(0, 2, (num_inputs, B))
    ref, port = [], []
    for i in range(num_inputs):
        msg = np.zeros(s["params"].n, dtype=np.int64)
        msg[:B] = bits[i]
        eb = F.split_ciphertext(F.encrypt(s["sk"], jax.random.key(100 * seed + i),
                                          jnp.asarray(msg)))
        a, b = np.asarray(eb.lwe.a)[:B], np.asarray(eb.lwe.b)[:B]
        ref.append(F.EncryptedBit(F.LWE(jnp.asarray(a), jnp.asarray(b))))
        port.append(T.EncryptedBit(interop.lwe(a, b, "cpu")))
    return bits, ref, port


def _check_outputs(s, circuit, bits, ref_out, got):
    assert len(got) == len(ref_out) == circuit.num_outputs
    for r, g in zip(ref_out, got):
        np.testing.assert_array_equal(np.asarray(r.lwe.a), interop.to_numpy(g.lwe.a))
        np.testing.assert_array_equal(np.asarray(r.lwe.b), interop.to_numpy(g.lwe.b))
    want = np.array([TC.evaluate_plain(circuit, bits[:, j]) for j in range(B)]).T
    np.testing.assert_array_equal(
        np.stack([T.decrypt_bit(s["tsk"], o).numpy() for o in got]), want)


@pytest.mark.parametrize("name,randomized", [("ripple_adder", False), ("comparator", True)],
                         ids=["ripple_adder-exact", "comparator-randomized"])
def test_evaluate_equals_reference(ref64, monkeypatch, name, randomized):
    s = ref64
    rc, tc = getattr(RC, name)(4), getattr(TC, name)(4)
    schedule = tc.schedule()
    if name == "comparator":
        assert [len(lv) for lv in schedule[:3]] == [4, 3, 2]  # 3 pairs pad to 4
    bits, ref_in, port_in = _inputs(s, tc.num_inputs, 1)
    key, e0, level_seeds = None, 40, None
    if randomized:
        key = jax.random.key(9)
        monkeypatch.setattr(rprg, "_EPOCH", itertools.count(e0))
        # the reference splits its key per level, then its bootstrap_batch
        # folds the next epoch into each level's key
        level_keys = jax.random.split(key, len(schedule))
        level_seeds = [tuple(int(w) for w in rrns.seed_words(jax.random.fold_in(k, e0 + i)))
                       for i, k in enumerate(level_keys)]
    ref_out = RC.evaluate(rc, s["params"], s["ctx"], s["bkey"], ref_in, key)
    got = TC.evaluate_internal(tc, s["params"], s["tctx"], s["tbk"], port_in, level_seeds)
    _check_outputs(s, tc, bits, ref_out, got)


def test_all_constant_circuit_equals_reference(ref64):
    """No inputs, no bootstraps: outputs are trivial encryptions, unbatched."""
    s = ref64
    out = []
    for mod in (RC, TC):
        c = mod.Circuit()
        one = c.const(1)
        c.output(one)
        c.output(c.not_(one))
        c.output(c.xor_(one, c.const(1)))
        c.output(c.or_(c.const(0), one))
        out.append(mod.evaluate(c, s["params"], s["ctx"] if mod is RC else s["tctx"],
                                s["bkey"] if mod is RC else s["tbk"], []))
    for r, g in zip(*out):
        assert g.lwe.a.shape == (s["params"].n,)
        np.testing.assert_array_equal(np.asarray(r.lwe.a), interop.to_numpy(g.lwe.a))
        np.testing.assert_array_equal(np.asarray(r.lwe.b), interop.to_numpy(g.lwe.b))
    assert [int(T.decrypt_bit(s["tsk"], o)) for o in out[1]] == [1, 0, 0, 1]


def test_public_evaluate_folds_and_splits(ref64):
    """evaluate = evaluate_internal on the folded words split per level;
    another epoch draws other masks; single (unbatched) inputs come back
    single; the gates decrypt right."""
    s = ref64
    assert T.circuit is TC and T.Circuit is TC.Circuit and T.evaluate_circuit is TC.evaluate
    c = TC.Circuit()
    x, y = c.input(), c.input()
    c.output(c.and_(x, y))
    c.output(c.xnor(x, y))
    bits, _, port_in = _inputs(s, 2, 2)
    args = (c, s["params"], s["tctx"], s["tbk"], port_in)
    got = TC.evaluate(*args, seed_words=(3, 4), epoch=6)
    want = TC.evaluate_internal(*args, prg.split_words(prg.fold_epoch((3, 4), 6), 1))
    other = T.evaluate_circuit(*args, seed_words=(3, 4), epoch=7)
    for g, w, o in zip(got, want, other):
        assert torch.equal(g.lwe.a, w.lwe.a) and torch.equal(g.lwe.b, w.lwe.b)
        assert not torch.equal(g.lwe.a, o.lwe.a)
    _check_outputs(s, c, bits, got, got)
    single = TC.evaluate(c, s["params"], s["tctx"], s["tbk"],
                         [T.EncryptedBit(T.LWE(e.lwe.a[0], e.lwe.b[0])) for e in port_in])
    assert single[0].lwe.a.shape == (s["params"].n,)
    assert [int(T.decrypt_bit(s["tsk"], o)) for o in single] == [
        bits[0, 0] & bits[1, 0], 1 - (bits[0, 0] ^ bits[1, 0])]
    with pytest.raises(ValueError, match="inputs"):
        TC.evaluate(c, s["params"], s["tctx"], s["tbk"], port_in[:1])
