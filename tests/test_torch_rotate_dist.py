"""The port's tensor-parallel rotation (sgfhe_tpu_torch/parallel/ntt_dist.py,
rotate_dist.py) on the CPU.

Against the JAX package, never through its shard_map entries: its
host-side tables (the cyclic NTT plan, the four-step plan and the rotation
plan's E map and monomial ladder) and its single-device bootstrap_batch on the same key and
gates in exact, randomized (the same rotation words) and prune = 1 modes.
Against the port's single-device path: the distributed polymul,
blind_rotate_dist, bootstrap_batch_tp in exact, randomized (same seed
words) and prune = 1 modes, and add_with_carry_dist at k = 1, n = 64, all
bit for bit. The dist runs happen in two gloo ranks spawned as processes
(tests/torch_dist_worker.py): at tp = 2, each rank holding its own rows of
the dist-order keys, then at tp = 1 on rank 0, while this process computes
the references. The forward four-step transform evaluates at the
documented E map and inverts."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# The twins issue many small ops: one thread each, or the parallel test
# workers oversubscribe the cores and run many times slower.
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import sgfhe_tpu as F  # noqa: E402
from sgfhe_tpu.ops import ntt as rntt  # noqa: E402
from sgfhe_tpu.ops import rns as rrns  # noqa: E402
from sgfhe_tpu.parallel import ntt_dist as rnd  # noqa: E402
from sgfhe_tpu.parallel import rotate_dist as rrd  # noqa: E402

import sgfhe_tpu_torch as T  # noqa: E402
import torch_dist_worker as W  # noqa: E402
from sgfhe_tpu_torch import interop  # noqa: E402
from sgfhe_tpu_torch.models import bootstrap as tbs  # noqa: E402
from sgfhe_tpu_torch.models import bootstrap2 as tb2  # noqa: E402
from sgfhe_tpu_torch.ops import ntt as tntt  # noqa: E402
from sgfhe_tpu_torch.parallel import ntt_dist as tnd  # noqa: E402
from sgfhe_tpu_torch.parallel import rotate_dist as trd  # noqa: E402
from sgfhe_tpu_torch.utils import primes as tpr  # noqa: E402

MODULI = F.Params.create(64).moduli  # p = 1 mod 1024: every plan below fits
SHAPES = [(8, 16), (16, 32)]


def _eq(ref, got):
    np.testing.assert_array_equal(np.asarray(ref).astype(np.int64),
                                  np.asarray(got).astype(np.int64))


@pytest.fixture(scope="module")
def ranks2(tmp_path_factory):
    """The suite on two gloo ranks, started first: it runs beside this
    process's own work."""
    return W.spawn("rotate", tmp_path_factory.mktemp("rotate"))


@pytest.fixture(scope="module")
def s(ranks2):
    return W.setup_rotate()


@pytest.fixture(scope="module")
def outs(ranks2, gate_refs, jax_refs):
    """Each rank's arrays, by tp size (collected after this process's
    references)."""
    ranks = ranks2.results()
    tp1 = {k[4:]: v for k, v in ranks[0].items() if k.startswith("tp1/")}
    return {1: [tp1], 2: [{k: v for k, v in r.items() if not k.startswith("tp1/")}
                          for r in ranks]}


@pytest.mark.parametrize("m", [16, 32, 512])
def test_cyclic_plan_equals_the_jax_package(m):
    ref = rntt.build_plan(MODULI, m, negacyclic=False)
    got = tntt.build_plan(MODULI, m, "cpu", negacyclic=False)
    for (rv, rs), (gv, gs) in zip(ref.fwd_tw + ref.inv_tw, got.fwd_tw + got.inv_tw):
        _eq(rv, gv)
        _eq(rs, gs)
    for name in ("pre_tw", "pre_tw_s", "post_tw", "post_tw_s", "mono_pow", "mono_pow_s"):
        _eq(getattr(ref, name), getattr(got, name))
    # the cyclic plan is the DFT over x^m - 1: evaluation at ω^br(idx)
    x = torch.randint(0, MODULI[0], (1, m))
    plan1 = tntt.build_plan(MODULI[:1], m, "cpu", negacyclic=False)
    p = MODULI[0]
    omega = tpr.root_of_unity(m, p)
    br = tntt._bit_reverse_indices(m)
    want = [sum(int(x[0, i]) * pow(omega, int(br[k]) * i, p) for i in range(m)) % p
            for k in range(0, m, max(1, m // 8))]
    _eq(want, tntt.ntt_fwd(plan1, x)[0, ::max(1, m // 8)])
    _eq(x, tntt.ntt_inv(plan1, tntt.ntt_fwd(plan1, x)))


@pytest.mark.parametrize("m1,m2", SHAPES)
def test_dist_and_rotation_plans_equal_the_jax_package(m1, m2):
    ref = rnd.build_dist_plan(MODULI, m1, m2)
    got = tnd.build_dist_plan(MODULI, m1, m2, "cpu")
    for name in ("tw", "tw_s", "tw_inv", "tw_inv_s", "pre", "pre_s", "post", "post_s"):
        _eq(getattr(ref, name), getattr(got, name))
    for sub in ("plan1", "plan2"):
        _eq(getattr(ref, sub).pre_tw, getattr(got, sub).pre_tw)
        _eq(getattr(ref, sub).post_tw, getattr(got, sub).post_tw)
    rref = rrd.build_rotation_plan(MODULI, m1, m2)
    rgot = trd.build_rotation_plan(MODULI, m1, m2, "cpu")
    _eq(rref.mono, rgot.mono)
    _eq(rref.mono_s, rgot.mono_s)
    assert (rgot.m1, rgot.m2) == (m1, m2)


@pytest.mark.parametrize("m1,m2", SHAPES)
def test_fwd_full_evaluation_map_and_round_trip(m1, m2):
    """fwd_full of x^i holds ψ^{E·i} at every hat position (E the module
    docstring's map), and inv_full inverts fwd_full."""
    m = m1 * m2
    rplan = trd.build_rotation_plan(MODULI, m1, m2, "cpu")
    E, _, _ = trd.rotation_tables_host(MODULI, m1, m2)
    L = len(MODULI)
    for i in (0, 1, 3, m - 1):
        x = torch.zeros((L, m), dtype=torch.int64)
        x[:, i] = 1
        hat = trd.fwd_full(rplan.dplan, x.reshape(L, m1, m2))
        for li, p in enumerate(MODULI):
            psi = tpr.root_of_unity(2 * m, p)
            want = np.vectorize(lambda e: pow(psi, int(e) * i, p))(E)
            _eq(want, hat[li])
    x = torch.randint(0, 1 << 30, (2, L, m1, m2)) % torch.tensor(MODULI).reshape(L, 1, 1)
    _eq(x, trd.inv_full(rplan.dplan, trd.fwd_full(rplan.dplan, x)))


@pytest.mark.parametrize("world", [1, 2])
def test_dist_polymul_equals_polymul(s, outs, world):
    plan = s["ctx"].plan_Q
    want = tntt.polymul(plan, *s["poly"]).numpy()
    for out in outs[world]:
        _eq(want, out["polymul"])


@pytest.mark.parametrize("world", [1, 2])
def test_blind_rotate_dist_equals_blind_rotate(s, outs, world):
    a, b = tbs.blind_rotate(s["params"], s["ctx"], s["bk"].hat, s["bk"].hat_shoup, s["ua"],
                            *s["acc"])
    for out in outs[world]:
        _eq(a, out["rot_a"])
        _eq(b, out["rot_b"])


# each mode's tp output key, and the JAX package's bootstrap_batch arguments
JAX_MODES = {"exact": ("tp_exact", {}),
             "randomized": ("tp_jax", dict(randomized=True, epoch=W.EPOCH)),
             "prune=1": ("tp_prune=1", dict(prune=1))}


@pytest.fixture(scope="module")
def jax_refs(s):
    """The JAX package's single-device bootstrap_batch in each mode on the
    port's key and the same 2 gates, as numpy."""
    params = F.Params.create(64)
    ctx = F.make_context(params)
    hat, shoup = (jnp.asarray(interop.to_numpy(t)) for t in (s["bk"].hat, s["bk"].hat_shoup))
    x, y = (F.LWE(jnp.asarray(lw.a.numpy(), jnp.uint32), jnp.asarray(lw.b.numpy(), jnp.uint32))
            for lw in W.gates(s, 2))
    key = jax.random.key(W.JAX_KEY)
    refs = {}
    for mode, (prefix, kw) in JAX_MODES.items():
        if kw.get("randomized"):
            kw = dict(kw, flat_key=key)
        triple = F.bootstrap_batch(params, ctx, hat, shoup, x, y, **kw)
        refs[mode] = W._lwes(prefix, (T.LWE(*(torch.as_tensor(np.asarray(v, np.int64))
                                              for v in (t.a, t.b))) for t in triple))
    return refs


@pytest.fixture(scope="module")
def gate_refs(s):
    """The port's single-device bootstrap_batch in each mode, 2 gates."""
    return {mode: W._lwes(f"tp_{mode}", T.bootstrap_batch(
        s["params"], s["ctx"], s["bk"].hat, s["bk"].hat_shoup, *W.gates(s, 2), **kw))
        for mode, kw in W.ROTATE_MODES.items()}


@pytest.mark.parametrize("mode", list(W.ROTATE_MODES))
@pytest.mark.parametrize("world", [1, 2])
def test_bootstrap_batch_tp_equals_bootstrap_batch(s, outs, gate_refs, world, mode):
    for out in outs[world]:
        for key, want in gate_refs[mode].items():
            _eq(want, out[key])
    m0, m1 = (m[:2].bool() for m in s["msgs"])
    for name, want in (("and", m0 & m1), ("or", m0 | m1), ("xor", m0 ^ m1)):
        lwe = T.LWE(torch.as_tensor(outs[world][0][f"tp_{mode}_{name}_a"]),
                    torch.as_tensor(outs[world][0][f"tp_{mode}_{name}_b"]))
        assert torch.equal(T.decrypt_bit(s["sk"], T.EncryptedBit(lwe)), want), name


@pytest.mark.parametrize("mode", list(JAX_MODES))
@pytest.mark.parametrize("world", [1, 2])
def test_bootstrap_tp_equals_the_jax_package(outs, jax_refs, world, mode):
    """The tp gates against the JAX package's single-device bootstrap_batch;
    randomized on the rotation words that package derives from its key and
    epoch."""
    if mode == "randomized":
        folded = jax.random.fold_in(jax.random.key(W.JAX_KEY), W.EPOCH)
        assert tuple(int(w) for w in rrns.seed_words(folded)) == W.JAX_SEED2
    for out in outs[world]:
        for key, want in jax_refs[mode].items():
            _eq(want, out[key])


@pytest.mark.parametrize("world", [1, 2])
def test_add_with_carry_dist_equals_add_with_carry(s, outs, world):
    lx, ly = (T.LWE(w.a[:2], w.b[:2]) for w in s["pairs"])
    digit, carry = tb2._add_with_carry(s["p2"], s["ctx2"], s["bk2"], lx, ly, None, None)
    z = s["xy"][0, :2] + s["xy"][1, :2]
    K = 2 ** s["p2"].k
    for out in outs[world]:
        _eq(digit.a, out["add_d_a"])
        _eq(digit.b, out["add_d_b"])
        _eq(carry.a, out["add_c_a"])
        _eq(carry.b, out["add_c_b"])
        got = T.LWE(torch.as_tensor(out["add_d_a"]), torch.as_tensor(out["add_d_b"]))
        assert torch.equal(tb2.decrypt_lwe(s["sk2"], got), z % K)
        got = T.LWE(torch.as_tensor(out["add_c_a"]), torch.as_tensor(out["add_c_b"]))
        assert torch.equal(tb2.decrypt_lwe(s["sk2"], got), z // K)
