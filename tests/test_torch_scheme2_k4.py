"""Scheme 2 at k = 4, n = 64 (m = 4096, L = 3) in the port against the JAX
package on the CPU: add_with_carry on two pairs, bit for bit, exact, with
prune = 2 and randomized (the JAX package's folded seed words given), on
the JAX package's keys; every digit and carry right."""

import pytest

torch = pytest.importorskip("torch")
# The twins issue many small ops: one thread each, or the parallel test
# workers oversubscribe the cores and run many times slower.
torch.set_num_threads(1)

import torch_s2_parity as par  # noqa: E402


@pytest.fixture(scope="module")
def toy_k4():
    return par.setup(4, 40)


@pytest.mark.parametrize("mode", ["exact", "prune=2", "randomized"])
def test_k4_add_with_carry_equals_reference(toy_k4, mode):
    par.check_add_with_carry(toy_k4, mode)
