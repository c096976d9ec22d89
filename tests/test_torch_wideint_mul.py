"""The port's mul_wide (sgfhe_tpu_torch/models/wideint.py) against the
JAX package's on the CPU, bit for bit, at the toy n = 64, k = 1, W = 2
and B = 2, deterministic and randomized, on the JAX package's keys and
digit ciphertexts (the fixture of tests/test_torch_wideint.py): all W²
digit products in one batched mul with lanes (i*W + j)-major, and the
columns reduced from their ends by add_with_carry."""

import itertools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# The twins issue many small ops: one thread each, or the parallel test
# workers oversubscribe the cores and run many times slower.
torch.set_num_threads(1)

import jax  # noqa: E402

from sgfhe_tpu.models import wideint as rwi  # noqa: E402
from sgfhe_tpu.ops import prg as rprg  # noqa: E402

from sgfhe_tpu_torch.models import wideint as twi  # noqa: E402

from test_torch_wideint import (  # noqa: E402
    W, _eq_digits, _folded, _port_args, _ref_args, _words, toy_setup)


@pytest.fixture(scope="module")
def toy_mul():
    return toy_setup(np.array([3, 2]), np.array([3, 1]))


@pytest.mark.parametrize("randomized", [False, True], ids=["exact", "randomized"])
def test_mul_wide_equals_reference(toy_mul, monkeypatch, randomized):
    """Lanes (i*W + j)-major in one batched mul, columns reduced from their
    ends; randomized, the reference splits its key state once per rotation
    call: the mul's subkey folds one epoch and splits into its three
    rounds, each column add's subkey folds the next."""
    s = toy_mul
    key = jax.random.key(31) if randomized else None
    seeds = None
    if randomized:
        state, subs = key, []
        for _ in range(1 + twi._mul_wide_adds(W)):
            state, sub = jax.random.split(state)
            subs.append(sub)
        seeds = [_words(k) for k in jax.random.split(jax.random.fold_in(subs[0], 50), 3)]
        seeds += _folded(subs[1:], 51)
    monkeypatch.setattr(rprg, "_EPOCH", itertools.count(50))
    ref = rwi.mul_wide(*_ref_args(s), s["xs"], s["ys"], key)
    got = twi._mul_wide(*_port_args(s), s["txs"], s["tys"], seeds)
    _eq_digits(ref, got)
    np.testing.assert_array_equal(twi.decrypt_wide(s["tsk"], got), s["xv"] * s["yv"])
