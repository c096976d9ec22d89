"""Scheme 2 at k = 5, n = 64 (m = 8192, L = 3, a 144 MiB key) in the port
against the JAX package on the CPU: add_with_carry on two pairs, bit for
bit, exact and randomized (the JAX package's folded seed words given), on
the JAX package's keys; every digit and carry right. prune = 2 and the key
through its seeded frame are tests/test_torch_scheme2_k5_key.py."""

import pytest

torch = pytest.importorskip("torch")
# The twins issue many small ops: one thread each, or the parallel test
# workers oversubscribe the cores and run many times slower.
torch.set_num_threads(1)

import torch_s2_parity as par  # noqa: E402


@pytest.fixture(scope="module")
def toy_k5():
    return par.setup(5, 50)


@pytest.mark.parametrize("mode", ["exact", "randomized"])
def test_k5_add_with_carry_equals_reference(toy_k5, mode):
    par.check_add_with_carry(toy_k5, mode)
