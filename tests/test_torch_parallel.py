"""The port's multi-device layer (sgfhe_tpu_torch/parallel/: mesh,
distributed, sharded; the meshes alone: tests/test_torch_mesh.py) at
Params(64) and scheme 2's k = 1, n = 64 on the CPU: at world size 1 in
this process, and at dp = 2 across two gloo ranks
spawned as processes (tests/torch_dist_worker.py). The sharded gates equal
the port's single-device bootstrap_batch bit for bit (8 gates, and 5 for
the pad and trim), and the JAX package's single-device bootstrap_batch on
the same inputs; the scheme-2 batches decrypt to their messages; two
processes join one group, build host-major meshes and reduce across it."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# The twins issue many small ops: one thread each, or the parallel test
# workers oversubscribe the cores and run many times slower.
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402
import torch.distributed as dist  # noqa: E402

import sgfhe_tpu as F  # noqa: E402

import sgfhe_tpu_torch as T  # noqa: E402
import torch_dist_worker as W  # noqa: E402
from sgfhe_tpu_torch import interop  # noqa: E402
from sgfhe_tpu_torch.models import scheme2 as ts2  # noqa: E402
from sgfhe_tpu_torch.parallel import distributed as pdist  # noqa: E402
from sgfhe_tpu_torch.parallel import mesh as pmesh  # noqa: E402


@pytest.fixture(scope="module")
def ranks2(tmp_path_factory):
    """The suite on two gloo ranks, started first: it runs beside this
    process's own work."""
    return W.spawn("gates", tmp_path_factory.mktemp("gates"))


@pytest.fixture(scope="module")
def world1(tmp_path_factory, ranks2):
    pdist.initialize(f"file://{tmp_path_factory.mktemp('pg1') / 'pg'}", 1, 0, device="cpu")
    yield pmesh.make_mesh()
    dist.destroy_process_group()


@pytest.fixture(scope="module")
def s():
    return W.setup_gates()


@pytest.fixture(scope="module")
def outs(s, world1, ranks2):
    """Each rank's arrays, by world size."""
    return {1: [W.run_gates(s, world1)], 2: ranks2.results()}


@pytest.fixture(scope="module")
def refs(s):
    """The port's single-device bootstrap_batch on the same gates."""
    out = {}
    for B in (8, 5):
        out.update(W._lwes(f"g{B}", T.bootstrap_batch(s["params"], s["ctx"], s["bk"].hat,
                                                     s["bk"].hat_shoup, *W.gates(s, B))))
    return out


@pytest.mark.parametrize("B", [8, 5])
@pytest.mark.parametrize("world", [1, 2])
def test_bootstrap_batch_sharded_equals_bootstrap_batch(outs, refs, world, B):
    for rank, out in enumerate(outs[world]):
        for key, want in refs.items():
            if key.startswith(f"g{B}_"):
                np.testing.assert_array_equal(out[key], want, err_msg=f"rank {rank} {key}")


def test_sharded_gates_equal_the_jax_package(s, outs):
    """The 8 sharded gates against the JAX package's single-device
    bootstrap_batch on the same numpy inputs and the same key."""
    params = F.Params.create(64)
    ctx = F.make_context(params)
    hat, shoup = (jnp.asarray(interop.to_numpy(t)) for t in (s["bk"].hat, s["bk"].hat_shoup))
    x, y = (F.LWE(jnp.asarray(lw.a.numpy(), jnp.uint32), jnp.asarray(lw.b.numpy(), jnp.uint32))
            for lw in W.gates(s, 8))
    ref = F.bootstrap_batch(params, ctx, hat, shoup, x, y)
    for out in outs[1] + outs[2]:
        for name, lwe in zip(("and", "or", "xor"), ref):
            np.testing.assert_array_equal(out[f"g8_{name}_a"], np.asarray(lwe.a))
            np.testing.assert_array_equal(out[f"g8_{name}_b"], np.asarray(lwe.b))
    m0, m1 = (m[:8].bool() for m in s["msgs"])
    for name, want in (("and", m0 & m1), ("or", m0 | m1), ("xor", m0 ^ m1)):
        lwe = T.LWE(torch.as_tensor(outs[2][0][f"g8_{name}_a"]),
                    torch.as_tensor(outs[2][0][f"g8_{name}_b"]))
        assert torch.equal(T.decrypt_bit(s["sk"], T.EncryptedBit(lwe)), want), name


@pytest.mark.parametrize("world", [1, 2])
def test_scheme2_batches_decrypt_equal(s, outs, world):
    """Each block is the port's own encryption from its seed, and every
    block decrypts to its message, sharded and one by one."""
    for out in outs[world]:
        np.testing.assert_array_equal(out["s2_dec"], s["m2"].numpy())
        for i, seed in enumerate(W.S2_SEEDS):
            a, b = ts2._encrypt_private(s["sk2"], torch.Generator().manual_seed(seed), s["m2"][i])
            np.testing.assert_array_equal(out["s2_a"][i], a.numpy())
            np.testing.assert_array_equal(out["s2_b"][i], b.numpy())
            np.testing.assert_array_equal(
                ts2.decrypt(s["sk2"], torch.as_tensor(out["s2_a"][i]),
                            torch.as_tensor(out["s2_b"][i])).numpy(), s["m2"][i].numpy())


def test_initialize_global_mesh_and_all_reduce_across_two_processes(outs):
    """initialize() joined both processes, make_global_mesh laid out
    (2, 1) and (1, 2) and refused tp = 4, and an all_reduce summed residues
    across the processes as numpy does."""
    for out in outs[2]:
        assert int(out["process_count"]) == 2
        assert tuple(out["mesh_tp1"]) == (2, 1) and tuple(out["mesh_tp2"]) == (1, 2)
        assert bool(out["tp4_refused"]) and bool(out["modsum_ok"])
