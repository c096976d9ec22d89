"""The port's wide-integer arithmetic (sgfhe_tpu_torch/models/wideint.py)
against the JAX package's (sgfhe_tpu/models/wideint.py) on the CPU, at
the toy n = 64, k = 1, on the JAX package's keys and digit ciphertexts
(carried over by interop.wide): add_wide and sub_wide with its [x >= y]
flag at W = 2, B = 4 bit for bit, deterministic and randomized (the JAX
package's epoch counter pinned, its folded words given in the order the
rotations run); min_max_wide randomized, its mux pass on the
unfolded split key as the JAX package draws it; eq_wide and sort_wide
against numpy on the port alone; the seed-word counts of the public ops;
and the public select_wide's fresh epoch per call. mul_wide is in
tests/test_torch_wideint_mul.py (its reference compiles take a file's
budget of their own)."""

import itertools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# The twins issue many small ops: one thread each, or the parallel test
# workers oversubscribe the cores and run many times slower.
torch.set_num_threads(1)

import jax  # noqa: E402

from sgfhe_tpu.models import scheme2 as rs2  # noqa: E402
from sgfhe_tpu.models import wideint as rwi  # noqa: E402
from sgfhe_tpu.ops import prg as rprg  # noqa: E402
from sgfhe_tpu.ops import rns as rrns  # noqa: E402

from sgfhe_tpu_torch import interop  # noqa: E402
from sgfhe_tpu_torch.models import bootstrap2 as tb2  # noqa: E402
from sgfhe_tpu_torch.models import scheme2 as ts2  # noqa: E402
from sgfhe_tpu_torch.models import wideint as twi  # noqa: E402
from sgfhe_tpu_torch.ops import prg  # noqa: E402

W, B = 2, 4


def toy_setup(xv, yv):
    """The JAX package's own wideint fixture (tests/test_wideint.py), its
    keys carried over, and the W-digit operands xv and yv encrypted."""
    params = rs2.Params.create(1, n=64)
    ctx = rs2.make_context(params)
    sk = rs2.PrivateKey.create(params, jax.random.key(1))
    bkey = rs2.BootstrapKey.create(ctx, sk, jax.random.key(2))
    tp = interop.scheme2_params(params)
    xs = rwi.encrypt_wide(sk, jax.random.key(9), xv, W)
    ys = rwi.encrypt_wide(sk, jax.random.key(10), yv, W)
    return dict(params=params, ctx=ctx, sk=sk, bkey=bkey, tp=tp,
                tctx=ts2.make_context(tp, device="cpu"),
                tsk=interop.private_key(tp, np.asarray(sk.key), "cpu"),
                tbk=interop.bootstrap_key(tp, np.asarray(bkey.hat), np.asarray(bkey.hat_shoup),
                                          "cpu"),
                xv=xv, yv=yv, xs=xs, ys=ys,
                txs=interop.wide(xs, "cpu"), tys=interop.wide(ys, "cpu"))


@pytest.fixture(scope="module")
def toy_k1():
    return toy_setup(np.array([3, 0, 2, 1]), np.array([3, 2, 1, 0]))  # a tie in lane 0


def _ref_args(s):
    return s["params"], s["ctx"], s["bkey"]


def _port_args(s):
    return s["tp"], s["tctx"], s["tbk"]


def _words(key):
    return tuple(int(w) for w in rrns.seed_words(key))


def _folded(keys, e0):
    """The words of rotations that each fold the next epoch into its key."""
    return [_words(jax.random.fold_in(k, e0 + i)) for i, k in enumerate(keys)]


def _eq_digits(ref, got):
    assert len(ref) == len(got)
    for r, g in zip(ref, got):
        np.testing.assert_array_equal(np.asarray(r.a), interop.to_numpy(g.a))
        np.testing.assert_array_equal(np.asarray(r.b), interop.to_numpy(g.b))


def _pin(monkeypatch, e0):
    monkeypatch.setattr(rprg, "_EPOCH", itertools.count(e0))


@pytest.mark.parametrize("N", [2, 4, 8, 16])
def test_oddeven_pairs_equal_reference(N):
    assert twi._oddeven_pairs(N) == rwi._oddeven_pairs(N)
    assert len(twi._oddeven_pairs(4)) == 5


def test_public_ops_split_one_pair_per_rotation(monkeypatch):
    """Each public op splits exactly as many seed-word pairs as it runs
    rotations (`mul` counts three), in the order they run: the rotations
    are stubbed to record the words they are given."""
    seen = []

    def fake_add(params, ctx, bkey, x, y, carry, seed2, prune=0):
        seen.append(seed2)
        return x, y

    def fake_mul(params, ctx, bkey, x, y, seeds, prune=0):
        seen.extend(seeds)
        return x, y

    monkeypatch.setattr(tb2, "_add_with_carry", fake_add)
    monkeypatch.setattr(tb2, "_mul", fake_mul)
    for width in (1, 2, 3, 4):
        xs = [twi.LWE(torch.zeros(1, 4, dtype=torch.int64), torch.zeros(1, dtype=torch.int64))
              for _ in range(width)]
        tp = ts2.Params.create(1, 64)
        for op, count in ((twi.add_wide, width), (twi.sub_wide, width),
                          (twi.mul_wide, 3 + twi._mul_wide_adds(width))):
            seen.clear()
            op(tp, None, None, xs, xs, seed_words=(1, 2), epoch=3)
            assert seen == prg.split_words(prg.fold_epoch((1, 2), 3), count)
    # W = 2: columns of 1, 3, 3 and 1 partial products reduce in 0 + 2 + 4 + 4 adds
    assert twi._mul_wide_adds(2) == 10


@pytest.mark.parametrize("randomized", [False, True], ids=["exact", "randomized"])
def test_add_and_sub_wide_equal_reference(toy_k1, monkeypatch, randomized):
    s = toy_k1
    key = jax.random.key(21) if randomized else None
    add_seeds = sub_seeds = None
    if randomized:
        keys = jax.random.split(key, W)  # one key a digit, each folded again
        add_seeds, sub_seeds = _folded(keys, 10), _folded(keys, 20)
    _pin(monkeypatch, 10)
    ref = rwi.add_wide(*_ref_args(s), s["xs"], s["ys"], key)
    got = twi._add_wide(*_port_args(s), s["txs"], s["tys"], add_seeds)
    _eq_digits(ref, got)
    np.testing.assert_array_equal(twi.decrypt_wide(s["tsk"], got), s["xv"] + s["yv"])
    _pin(monkeypatch, 20)
    ref_d, ref_ge = rwi.sub_wide(*_ref_args(s), s["xs"], s["ys"], key)
    got_d, got_ge = twi._sub_wide(*_port_args(s), s["txs"], s["tys"], sub_seeds)
    _eq_digits(ref_d + [ref_ge], got_d + [got_ge])
    np.testing.assert_array_equal(twi.decrypt_wide(s["tsk"], got_d),
                                  (s["xv"] - s["yv"]) % 2 ** W)
    np.testing.assert_array_equal(tb2.decrypt_lwe(s["tsk"], got_ge).numpy(), s["xv"] >= s["yv"])
    np.testing.assert_array_equal(tb2.decrypt_lwe(s["tsk"], twi.flag_not(s["tp"], got_ge)).numpy(),
                                  s["xv"] < s["yv"])


def test_min_max_wide_randomized_equals_reference(toy_k1, monkeypatch):
    """The comparison's adds fold epochs; the JAX package's mux pass takes
    its half of the split key unfolded, and the port's internal form is
    given those words as they are."""
    s = toy_k1
    key = jax.random.key(41)
    k1, k2 = jax.random.split(key)
    seeds = _folded(jax.random.split(k1, W), 60) + [_words(k2)]
    _pin(monkeypatch, 60)
    ref = rwi.min_max_wide(*_ref_args(s), s["xs"], s["ys"], key)
    got = twi._min_max_wide(*_port_args(s), s["txs"], s["tys"], seeds)
    _eq_digits(ref[0] + ref[1], got[0] + got[1])
    np.testing.assert_array_equal(twi.decrypt_wide(s["tsk"], got[0]),
                                  np.minimum(s["xv"], s["yv"]))
    np.testing.assert_array_equal(twi.decrypt_wide(s["tsk"], got[1]),
                                  np.maximum(s["xv"], s["yv"]))


def test_eq_and_sort_wide_against_numpy(toy_k1):
    """Port-made encryptions under the carried-over key: eq_wide with ties
    and sort_wide's network of N = 4 (five comparators), randomized."""
    s = toy_k1
    g = torch.Generator().manual_seed(3)
    tp, tsk = s["tp"], s["tsk"]
    xv, yv = np.array([1, 2, 3, 0]), np.array([1, 3, 3, 2])
    xs, ys = twi.encrypt_wide(tsk, g, xv, W), twi.encrypt_wide(tsk, g, yv, W)
    np.testing.assert_array_equal(twi.decrypt_wide(tsk, xs), xv)
    eq = twi.eq_wide(*_port_args(s), xs, ys)
    np.testing.assert_array_equal(tb2.decrypt_lwe(tsk, eq).numpy(), xv == yv)
    vals = np.array([[3], [0], [2], [1]])  # 4 items of B = 1
    items = [twi.encrypt_wide(tsk, g, v, W) for v in vals]
    out = twi.sort_wide(*_port_args(s), items, seed_words=(5, 6))
    np.testing.assert_array_equal(np.stack([twi.decrypt_wide(tsk, it) for it in out]),
                                  np.sort(vals, axis=0))


def test_public_select_wide_folds_a_fresh_epoch(toy_k1):
    """Two public select_wide calls with the same seed words draw other
    masks (the JAX package's replay one stream); both select right; a
    pinned epoch equals the internal mux pass on the folded, split words."""
    s = toy_k1
    args = _port_args(s)
    xs, ys = s["txs"][:1], s["tys"][:1]
    flag = twi.ge_wide(*args, xs, ys)  # a refreshed [x0 >= y0] flag
    first = twi.select_wide(*args, flag, xs, ys, seed_words=(7, 8))
    second = twi.select_wide(*args, flag, xs, ys, seed_words=(7, 8))
    assert not torch.equal(first[0].a, second[0].a)
    want = np.where(s["xv"] % 2 >= s["yv"] % 2, s["xv"] % 2, s["yv"] % 2)
    for out in (first, second):
        np.testing.assert_array_equal(twi.decrypt_wide(s["tsk"], out), want)
    pinned = twi.select_wide(*args, flag, xs, ys, seed_words=(7, 8), epoch=4)
    words = prg.split_words(prg.fold_epoch((7, 8), 4), 1)[0]
    internal = twi._mux_pass(*args, flag, [(xs, ys)], words)[0]
    assert torch.equal(pinned[0].a, internal[0].a) and torch.equal(pinned[0].b, internal[0].b)
