"""Scheme 2 at k = 5, n = 64 (m = 8192, L = 3, a 144 MiB key) on the CPU:
the JAX package's bootstrap key regenerates bit for bit in the port from
its seeded frame (the key's layout and stream 2 at this size), and
add_with_carry with prune = 2 on two pairs equals the JAX package's bit for
bit on that key, every digit and carry right."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# The twins issue many small ops: one thread each, or the parallel test
# workers oversubscribe the cores and run many times slower.
torch.set_num_threads(1)

from sgfhe_tpu import serialize as RS  # noqa: E402

from sgfhe_tpu_torch import interop  # noqa: E402
from sgfhe_tpu_torch import serialize as TS  # noqa: E402
from sgfhe_tpu_torch.ops import fused  # noqa: E402

import torch_s2_parity as par  # noqa: E402


@pytest.fixture(scope="module")
def toy_k5():
    return par.setup(5, 50)


def test_k5_key_layout_and_seeded_frame_equal_reference(toy_k5):
    tp, bkey = toy_k5["tp"], toy_k5["bkey"]
    assert (tp.m, tp.num_limbs, tp.r) == (8192, 3, 16384)
    assert bkey.hat.shape == (64, 2 * tp.num_digits, 2, tp.num_limbs, tp.m)
    assert fused.fused_bkey_bytes(tp) == 2 * bkey.hat.size * 4 == 144 * 2**20
    got = TS.from_wire(RS.bootstrap_key_to_wire_seeded(bkey), toy_k5["tctx"])
    assert got.params == tp
    np.testing.assert_array_equal(np.asarray(bkey.hat), interop.to_numpy(got.hat))
    np.testing.assert_array_equal(np.asarray(bkey.hat_shoup), interop.to_numpy(got.hat_shoup))
    np.testing.assert_array_equal(interop.to_numpy(toy_k5["tbk"].hat), interop.to_numpy(got.hat))


def test_k5_add_with_carry_prune2_equals_reference(toy_k5):
    par.check_add_with_carry(toy_k5, "prune=2")
