"""The port's sharded repack (parallel/sharded.pack_encrypted_bits_sharded)
at Params(64) on the CPU, at world size 1 in this process and across two
gloo ranks spawned as processes (tests/torch_dist_worker.py): the
Ciphertext equals the port's single-device pack_encrypted_bits bit for
bit and decrypts to the message. A file of its own: the 64 bootstraps of
a pack are most of a minute's CPU time in all."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# The twins issue many small ops: one thread each, or the parallel test
# workers oversubscribe the cores and run many times slower.
torch.set_num_threads(1)

import torch.distributed as dist  # noqa: E402

import sgfhe_tpu_torch as T  # noqa: E402
import torch_dist_worker as W  # noqa: E402
from sgfhe_tpu_torch.parallel import distributed as pdist  # noqa: E402
from sgfhe_tpu_torch.parallel import mesh as pmesh  # noqa: E402


@pytest.fixture(scope="module")
def ranks2(tmp_path_factory):
    return W.spawn("pack", tmp_path_factory.mktemp("pack"))


@pytest.fixture(scope="module")
def world1(tmp_path_factory, ranks2):
    pdist.initialize(f"file://{tmp_path_factory.mktemp('pg1') / 'pg'}", 1, 0, device="cpu")
    yield pmesh.make_mesh()
    dist.destroy_process_group()


@pytest.fixture(scope="module")
def s():
    return W.setup_pack()


@pytest.fixture(scope="module")
def outs(s, world1, ranks2):
    return {1: [W.run_pack(s, world1)], 2: ranks2.results()}


@pytest.fixture(scope="module")
def ref(s):
    return T.pack_encrypted_bits(s["params"], s["ctx"], s["bk"], T.EncryptedBit(s["bits"][0]))


@pytest.mark.parametrize("world", [1, 2])
def test_pack_sharded_equals_pack_encrypted_bits(s, outs, ref, world):
    """Each rank returns the whole Ciphertext."""
    for out in outs[world]:
        np.testing.assert_array_equal(out["pack_a"], ref.rlwe.a.numpy())
        np.testing.assert_array_equal(out["pack_b"], ref.rlwe.b.numpy())
        ct = T.Ciphertext(s["params"], T.RLWE(torch.as_tensor(out["pack_a"]),
                                              torch.as_tensor(out["pack_b"])))
        got = T.decrypt(s["sk"], ct)
        assert torch.equal(got[: s["params"].n], s["msgs"][0].bool())
