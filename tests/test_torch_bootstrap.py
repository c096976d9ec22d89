"""The port's gate bootstrap against the JAX package's plain path, bit for
bit, at Params(64) on the JAX package's keys (carried over by
sgfhe_tpu_torch.interop): exact, pruned and randomized modes, near-2^29
moduli, the Q->r switch, and the prune guard. The rotation's step
wrappers are held against the twin in both T-modes on the CPU (their plain
versions); tests/test_torch_kernels.py holds the CUDA kernels against the
twin on a card."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# The twins issue many small ops: one thread each, or the parallel test
# workers oversubscribe the cores and run many times slower.
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import sgfhe_tpu as F  # noqa: E402
from sgfhe_tpu.models import bootstrap as rbs  # noqa: E402
from sgfhe_tpu.ops import rns as rrns  # noqa: E402
from sgfhe_tpu.utils import primes as rpr  # noqa: E402

import sgfhe_tpu_torch as T  # noqa: E402
from sgfhe_tpu_torch import interop  # noqa: E402
from sgfhe_tpu_torch.models import bootstrap as tbs  # noqa: E402
from sgfhe_tpu_torch.ops import fused as tfused  # noqa: E402


def _setup(params, seed):
    ctx = F.make_context(params)
    k_sk, k_bk = jax.random.split(jax.random.key(seed))
    sk = F.PrivateKey.create(params, k_sk)
    bkey = F.BootstrapKey.create(ctx, sk, k_bk)
    tctx = T.make_context(params, device="cpu")
    tbk = interop.bootstrap_key(
        params, np.asarray(bkey.hat), np.asarray(bkey.hat_shoup), "cpu"
    )
    rng = np.random.default_rng(seed)
    B = 4
    a1 = rng.integers(0, params.r, (B, params.n))
    a2 = rng.integers(0, params.r, (B, params.n))
    lwes = (a1, a1[:, 3], a2, a2[:, 5])
    return dict(params=params, ctx=ctx, bkey=bkey, tctx=tctx, tbk=tbk, lwes=lwes)


@pytest.fixture(scope="module")
def ref64():
    return _setup(F.Params.create(64), 77)


@pytest.fixture(scope="module")
def big_limbs():
    """Near-2^29 limbs with l = 3: 12*p_max > 2^32, so every lazy-reduction
    reset of the TPU kernels fires there (tests/test_fused.py)."""
    base = F.Params.create(64)
    mods = rpr.find_rns_primes(2 * base.m, 1 << 86, (1 << 87) - 1, 3)
    assert 12 * max(mods) > (1 << 32)
    return _setup(dataclasses.replace(base, moduli=mods), 21)


def _run_ref(s, seed_key, prune):
    a1, b1, a2, b2 = (jnp.asarray(x, jnp.uint32) for x in s["lwes"])
    return rbs.bootstrap_internal(
        s["params"], s["ctx"], s["bkey"].hat, s["bkey"].hat_shoup, a1, b1, a2, b2,
        seed_key, fused=("none", False), prune=prune,
    )


def _run_port(s, seed2, prune):
    a1, b1, a2, b2 = (torch.as_tensor(x) for x in s["lwes"])
    return tbs.bootstrap_internal(
        s["params"], s["tctx"], s["tbk"].hat, s["tbk"].hat_shoup, a1, b1, a2, b2,
        seed2, prune,
    )


def _assert_triples_equal(ref, got):
    for (ra, rb), (ga, gb) in zip(ref, got):
        np.testing.assert_array_equal(np.asarray(ra), interop.to_numpy(ga))
        np.testing.assert_array_equal(np.asarray(rb), interop.to_numpy(gb))


@pytest.mark.parametrize(
    "prune,randomized",
    [(0, False), (1, False), (2, False), (0, True)],
    ids=["exact", "prune1", "prune2", "randomized"],
)
def test_bootstrap_internal_equals_reference(ref64, prune, randomized):
    key = jax.random.key(13) if randomized else None
    seed2 = tuple(int(w) for w in rrns.seed_words(key)) if randomized else None
    ref = _run_ref(ref64, key, prune)
    got = _run_port(ref64, seed2, prune)
    _assert_triples_equal(ref, got)
    if not (prune or randomized):
        # the exact Q -> r switch on the same Q-domain LWEs
        for r_lwe, g_lwe in zip(ref, got):
            r_out = rbs._reduce_lwe(ref64["params"], ref64["ctx"], r_lwe)
            g_out = tbs._reduce_lwe(ref64["params"], ref64["tctx"], g_lwe)
            np.testing.assert_array_equal(np.asarray(r_out.a), interop.to_numpy(g_out.a))
            np.testing.assert_array_equal(np.asarray(r_out.b), interop.to_numpy(g_out.b))


def test_big_limbs_equal_reference(big_limbs):
    _assert_triples_equal(_run_ref(big_limbs, None, 0), _run_port(big_limbs, None, 0))


def _rotation_inputs(s, seed):
    params, tctx = s["params"], s["tctx"]
    rng = np.random.default_rng(seed)
    B, L, m = 3, params.num_limbs, params.m
    p = np.array(params.moduli).reshape(L, 1)
    ua = torch.as_tensor(rng.integers(0, 2 * m, (B, params.n)))
    a0 = torch.as_tensor(rng.integers(0, 1 << 30, (B, L, m)) % p)
    b0 = torch.as_tensor(rng.integers(0, 1 << 30, (B, L, m)) % p)
    return tctx, ua, a0, b0


@pytest.mark.parametrize(
    "case,prune,seed2",
    [
        ("randomized-wmul", 0, (0x9E3779B9, 12345)),
        ("exact-wmul", 0, None),
        ("prune1-wmul", 1, None),
        ("randomized-prune1-wmul", 1, (0x9E3779B9, 12345)),
        ("prune2-wmul", 2, None),
        ("big-limbs-wmul", 0, None),
    ],
)
def test_step_wrappers_equal_twin(ref64, big_limbs, case, prune, seed2):
    """The two step wrappers' plain versions, looped as on the card, equal
    the twin's rotation."""
    s = big_limbs if case.startswith("big") else ref64
    tctx, ua, a0, b0 = _rotation_inputs(s, 5)
    want = tbs.blind_rotate(
        s["params"], tctx, s["tbk"].hat, s["tbk"].hat_shoup, ua, a0, b0, seed2, prune
    )
    got = tfused.blind_rotate_steps(tctx, s["tbk"].hat, ua, a0, b0, seed2, prune)
    for w, g in zip(want, got):
        assert torch.equal(w, g)


def test_prune_guard(ref64):
    params = dataclasses.replace(ref64["params"], moduli=(11, 13, 101))
    with pytest.raises(AssertionError, match="digit pruning"):
        tbs.blind_rotate(params, ref64["tctx"], None, None, None, None, None, prune=2)


def test_route_follows_device_and_key_size():
    p64, p512 = T.Params.create(64), T.Params.create(512)
    cpu, cuda = torch.device("cpu"), torch.device("cuda")
    assert tbs._rotation_route(p64, cpu) == "plain"
    assert tbs._rotation_route(p512, cpu) == "plain"
    assert tbs._rotation_route(p64, cuda) == "resident"
    assert tbs._rotation_route(p512, cuda) == "wmul"
