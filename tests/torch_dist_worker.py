"""Ranks of the port's multi-device tests (tests/test_torch_parallel.py,
test_torch_parallel_pack.py, test_torch_rotate_dist.py). It imports torch,
numpy and the port only, never JAX.

Each suite has a set-up, made the same in every process from fixed seeds
(the port's keys from a CPU torch.Generator), and a run on a mesh that
returns numpy arrays. A test runs the "gates" and "pack" suites in its own
process at world size 1 and, through `spawn`, in a group of gloo ranks;
the "rotate" suite runs only in the spawned group, at tp = 2 and then, on
rank 0 alone, at tp = 1. Each rank is a process of

    python tests/torch_dist_worker.py <suite> <rank> <world> <init_file> <out_dir>

which joins the group by the file <init_file>, runs the suite and writes
its arrays to <out_dir>/<suite>-<rank>.npz.
"""

from __future__ import annotations

import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402
import torch  # noqa: E402

# The twins issue many small ops: one thread each, or the parallel test
# workers oversubscribe the cores and run many times slower.
torch.set_num_threads(1)

import torch.distributed as dist  # noqa: E402

import sgfhe_tpu_torch as T  # noqa: E402
from sgfhe_tpu_torch.models import bootstrap as tbs  # noqa: E402
from sgfhe_tpu_torch.models import bootstrap2 as tb2  # noqa: E402
from sgfhe_tpu_torch.models import scheme2 as ts2  # noqa: E402
from sgfhe_tpu_torch.parallel import distributed as pdist  # noqa: E402
from sgfhe_tpu_torch.parallel import mesh as pmesh  # noqa: E402
from sgfhe_tpu_torch.parallel import ntt_dist as nd  # noqa: E402
from sgfhe_tpu_torch.parallel import rotate_dist as rd  # noqa: E402
from sgfhe_tpu_torch.parallel import sharded  # noqa: E402

SEED_WORDS, EPOCH = (0x2468ACE0, 0x13579BDF), 3  # randomized mode, epoch pinned
# the rotation's words in the JAX package's randomized bootstrap_batch with
# flat_key=jax.random.key(21), epoch=3 (tests/test_torch_rotate_dist.py
# derives them there and checks them)
JAX_KEY, JAX_SEED2 = 21, (0xFF22283A, 0xDF637BFF)
S2_SEEDS = (101, 102, 103)  # three scheme-2 blocks: an odd batch


def scheme1_keys(seed: int = 11) -> dict:
    """Params(64) on the CPU: context, private and bootstrap keys, and two
    encrypted 64-bit messages split into bits."""
    params = T.Params.create(64)
    ctx = T.make_context(params, device="cpu")
    g = torch.Generator().manual_seed(seed)
    sk = T.PrivateKey.create(params, g, device="cpu")
    bk = T.BootstrapKey.create(ctx, sk, g)
    msgs = [torch.randint(0, 2, (params.n,), generator=g) for _ in range(2)]
    bits = [T.split_ciphertext(T.encrypt(sk, g, m)).lwe for m in msgs]
    return dict(params=params, ctx=ctx, sk=sk, bk=bk, msgs=msgs, bits=bits)


def gates(s: dict, B: int):
    """The first B gate pairs (bit i of message 0, bit i of message 1)."""
    x, y = s["bits"]
    return T.LWE(x.a[:B], x.b[:B]), T.LWE(y.a[:B], y.b[:B])


def _lwes(prefix: str, lwes) -> dict:
    out = {}
    for name, lwe in zip(("and", "or", "xor"), lwes):
        out[f"{prefix}_{name}_a"] = lwe.a.numpy()
        out[f"{prefix}_{name}_b"] = lwe.b.numpy()
    return out


# ---- suite "gates": bootstrap_batch_sharded, scheme-2 batches, the runtime --


def setup_gates() -> dict:
    s = scheme1_keys()
    p2 = ts2.Params.create(1, 64)
    g = torch.Generator().manual_seed(5)
    s["p2"] = p2
    s["sk2"] = ts2.PrivateKey.create(p2, g, device="cpu")
    s["m2"] = torch.randint(0, 2**p2.k, (len(S2_SEEDS), p2.n), generator=g)
    return s


def run_gates(s: dict, mesh) -> dict:
    out = {}
    for B in (8, 5):
        out.update(_lwes(f"g{B}", sharded.bootstrap_batch_sharded(
            s["params"], s["ctx"], s["bk"], *gates(s, B), mesh)))
    a, b = sharded.scheme2_encrypt_batch_sharded(s["sk2"], S2_SEEDS, s["m2"], mesh)
    out["s2_a"], out["s2_b"] = a.numpy(), b.numpy()
    out["s2_dec"] = sharded.scheme2_decrypt_batch_sharded(s["sk2"], a, b, mesh).numpy()
    return out


def runtime_checks() -> dict:
    """make_global_mesh's layouts and asserts, and a modular reduction of
    residues over the world by all_reduce, against numpy."""
    world, rank = dist.get_world_size(), dist.get_rank()
    out = {"process_count": np.array(pdist.process_count())}
    out["mesh_tp1"] = np.array(pdist.make_global_mesh(tp=1).shape)
    out["mesh_tp2"] = np.array(pdist.make_global_mesh(tp=2).shape)
    try:
        pdist.make_global_mesh(tp=4)
        out["tp4_refused"] = np.array(False)
    except AssertionError:
        out["tp4_refused"] = np.array(True)
    p = (1 << 27) + 1
    full = np.random.default_rng(7).integers(0, p, (8, 16))
    rows = 8 // world
    x = torch.tensor(full[rank * rows:(rank + 1) * rows])
    dist.all_reduce(x)
    want = full.reshape(world, rows, 16).sum(0) % p
    out["modsum_ok"] = np.array(np.array_equal(torch.remainder(x, p).numpy(), want))
    return out


# ---- suite "pack": pack_encrypted_bits_sharded ---------------------------------


def setup_pack() -> dict:
    return scheme1_keys()


def run_pack(s: dict, mesh) -> dict:
    ct = sharded.pack_encrypted_bits_sharded(s["params"], s["ctx"], s["bk"], s["bits"][0], mesh)
    return {"pack_a": ct.rlwe.a.numpy(), "pack_b": ct.rlwe.b.numpy()}


# ---- suite "rotate": the tensor-parallel rotation ------------------------------

ROTATE_MODES = {"exact": {}, "randomized": dict(seed_words=SEED_WORDS, epoch=EPOCH),
                "prune=1": dict(prune=1)}
M1, M2 = 16, 32  # Params(64) and scheme 2 at k = 1, n = 64: m = 512


def setup_rotate() -> dict:
    s = scheme1_keys()
    s["rplan"] = rd.build_rotation_plan(s["params"].moduli, M1, M2, "cpu")
    p2 = ts2.Params.create(1, 64)
    ctx2 = ts2.make_context(p2, device="cpu")
    g = torch.Generator().manual_seed(9)
    sk2 = ts2.PrivateKey.create(p2, g, device="cpu")
    s.update(p2=p2, ctx2=ctx2, sk2=sk2, bk2=ts2.BootstrapKey.create(ctx2, sk2, g),
             rplan2=rd.build_rotation_plan(p2.moduli, M1, M2, "cpu"))
    s["xy"] = torch.randint(0, 2**p2.k, (2, p2.n), generator=g)
    s["pairs"] = [tb2.split_ciphertext(p2, *ts2.encrypt(sk2, g, v)) for v in s["xy"]]
    gen = torch.Generator().manual_seed(4)
    params = s["params"]
    L, m, p = params.num_limbs, params.m, s["ctx"].plan_Q.p
    s["ua"] = torch.randint(0, 2 * m, (2, params.n), generator=gen)
    s["acc"] = [torch.randint(0, 1 << 30, (2, L, m), generator=gen) % p for _ in range(2)]
    s["poly"] = [torch.randint(0, 1 << 30, (2, L, m), generator=gen) % p for _ in range(2)]
    return s


def run_rotate(s: dict, mesh) -> dict:
    """Each case on the mesh's tp axis, every rank holding its own rows of
    the dist-order keys (bkey_to_dist's `part`); "tp_jax" is the gate
    bootstrap on the JAX package's rotation words, used as given."""
    params, ctx, rplan = s["params"], s["ctx"], s["rplan"]
    group = mesh.get_group("tp")
    part = (dist.get_rank(group), dist.get_world_size(group))
    out = {}
    keys = {prune: rd.bkey_to_dist(ctx, rplan, s["bk"].hat, prune, part) for prune in (0, 1)}
    a, b = rd.blind_rotate_dist(params, ctx, rplan, mesh, keys[0], s["ua"], *s["acc"])
    out["rot_a"], out["rot_b"] = a.numpy(), b.numpy()
    for mode, kw in ROTATE_MODES.items():
        out.update(_lwes(f"tp_{mode}", rd.bootstrap_batch_tp(
            params, ctx, rplan, mesh, keys[kw.get("prune", 0)], *gates(s, 2), **kw)))
    x, y = gates(s, 2)
    out.update(_lwes("tp_jax", (tbs._reduce_lwe(params, ctx, t) for t in
                                rd.bootstrap_internal_dist(params, ctx, rplan, mesh, keys[0],
                                                           x.a, x.b, y.a, y.b,
                                                           seed2=JAX_SEED2))))
    key2 = rd.bkey_to_dist(s["ctx2"], s["rplan2"], s["bk2"].hat, 0, part)
    lx, ly = (T.LWE(w.a[:2], w.b[:2]) for w in s["pairs"])
    digit, carry = rd.add_with_carry_dist(s["p2"], s["ctx2"], s["rplan2"], mesh, key2, lx, ly)
    out.update(add_d_a=digit.a.numpy(), add_d_b=digit.b.numpy(), add_c_a=carry.a.numpy(),
               add_c_b=carry.b.numpy())
    mul = nd.make_dist_polymul(rplan.dplan, mesh)
    x, y = (v.reshape(2, params.num_limbs, M1, M2) for v in s["poly"])
    out["polymul"] = mul(x, y).reshape(s["poly"][0].shape).numpy()
    return out


SUITES = {
    "gates": (setup_gates, run_gates, lambda world: pmesh.make_mesh(dp=world, tp=1)),
    "pack": (setup_pack, run_pack, lambda world: pmesh.make_mesh(dp=world, tp=1)),
    "rotate": (setup_rotate, run_rotate, lambda world: pmesh.make_mesh(dp=1, tp=world)),
}


def tp1_on_rank0(setup: dict) -> dict:
    """The rotate suite at tp = 1: on a (world, 1) mesh each rank is its own
    tp group; rank 0 runs it (keys prefixed "tp1/"), the others return
    nothing."""
    mesh = pmesh.make_mesh(dp=dist.get_world_size(), tp=1)
    if dist.get_rank() != 0:
        return {}
    return {f"tp1/{k}": v for k, v in run_rotate(setup, mesh).items()}


class Spawned:
    """A group of `world` gloo ranks running one suite (started by `spawn`)."""

    def __init__(self, suite: str, tmp: Path, world: int):
        self.suite, self.tmp, self.world = suite, tmp, world
        env = {k: v for k, v in os.environ.items()
               if not k.startswith(("JAX_", "XLA_", "MASTER_", "RANK", "WORLD_SIZE",
                                    "LOCAL_RANK"))}
        env["OMP_NUM_THREADS"] = "1"
        self.procs = [
            subprocess.Popen([sys.executable, __file__, suite, str(r), str(world),
                              str(tmp / "pg"), str(tmp)], cwd=ROOT, env=env,
                             stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for r in range(world)
        ]

    def results(self, timeout: float = 240) -> list:
        """Each rank's arrays, after every rank has ended well."""
        outs = []
        try:
            for p in self.procs:
                outs.append(p.communicate(timeout=timeout)[0])
        finally:
            for p in self.procs:
                if p.poll() is None:
                    p.kill()
                    p.communicate()
        for r, (p, text) in enumerate(zip(self.procs, outs)):
            assert p.returncode == 0, f"rank {r} of {self.suite} failed:\n{text}"
        return [dict(np.load(self.tmp / f"{self.suite}-{r}.npz")) for r in range(self.world)]


def spawn(suite: str, tmp: Path, world: int = 2) -> Spawned:
    return Spawned(suite, Path(tmp), world)


def main(argv) -> None:
    suite, rank, world, init_file, out_dir = argv
    rank, world = int(rank), int(world)
    pdist.initialize(f"file://{init_file}", world, rank, device="cpu")
    try:
        setup, run, make = SUITES[suite]
        s = setup()
        out = run(s, make(world))
        if suite == "gates":
            out.update(runtime_checks())
        if suite == "rotate":
            out.update(tp1_on_rank0(s))
        np.savez(Path(out_dir) / f"{suite}-{rank}.npz", **out)
    finally:
        dist.destroy_process_group()
    print(f"rank {rank} of {world}: {suite} ok")


if __name__ == "__main__":
    main(sys.argv[1:])
