"""The port's RNS flatten (deterministic and randomized, also on the
global counters c0 of the tensor-parallel rotation), Threefry, exact Q->r
switch and negacyclic bit product against the JAX package, bit for bit, on
the CPU."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# The twins issue many small ops: one thread each, or the parallel test
# workers oversubscribe the cores and run many times slower.
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import sgfhe_tpu as F  # noqa: E402
from sgfhe_tpu.ops import poly as rpoly  # noqa: E402
from sgfhe_tpu.ops import prg as rprg  # noqa: E402
from sgfhe_tpu.ops import rns as rrns  # noqa: E402

import sgfhe_tpu_torch as T  # noqa: E402
from sgfhe_tpu_torch.ops import poly as tpoly  # noqa: E402
from sgfhe_tpu_torch.ops import prg as tprg  # noqa: E402
from sgfhe_tpu_torch.ops import rns as trns  # noqa: E402


def _np(t):
    return t.cpu().numpy()


def _eq(ref, got):
    np.testing.assert_array_equal(np.asarray(ref).astype(np.int64), _np(got))


@pytest.fixture(scope="module")
def rns64():
    params = F.Params.create(64)
    mods = params.moduli
    ref = rrns.build_context(mods).device_context()
    got = trns.build_context(mods).device_context("cpu")
    rng = np.random.default_rng(64)
    L = len(mods)
    x = rng.integers(0, 1 << 30, (5, L, params.m)) % np.array(mods).reshape(L, 1)
    return params, ref, got, x


@pytest.mark.parametrize("prune", [0, 1, 2])
def test_flatten_equals_reference(rns64, prune):
    params, ref, got, x = rns64
    r = jax.jit(rrns.flatten, static_argnums=2)(ref, jnp.asarray(x, jnp.uint32), prune)
    _eq(r, trns.flatten(got, torch.as_tensor(x), prune))


def test_threefry_known_answers_and_reference():
    # Random123 known-answer vectors for Threefry-2x32-20
    assert tprg.threefry2x32(0, 0, 0, 0) == (0x6B200159, 0x99BA4EFE)
    f = 0xFFFFFFFF
    assert tprg.threefry2x32(f, f, f, f) == (0x1CB996FC, 0xBB002BE7)
    rng = np.random.default_rng(3)
    k0, k1 = (int(v) for v in rng.integers(0, 1 << 32, 2))
    c0 = rng.integers(0, 1 << 32, 257)
    c1 = rng.integers(0, 1 << 32, 257)
    r0, r1 = rprg.threefry2x32(
        np.uint32(k0), np.uint32(k1), jnp.asarray(c0, jnp.uint32), jnp.asarray(c1, jnp.uint32)
    )
    g0, g1 = tprg.threefry2x32(k0, k1, torch.as_tensor(c0), torch.as_tensor(c1))
    _eq(r0, g0)
    _eq(r1, g1)


@pytest.mark.parametrize("prune", [0, 1])
def test_flatten_random_equals_reference(rns64, prune):
    params, ref, got, x = rns64
    lo, hi = rrns.seed_words(jax.random.key(13))
    r = rrns.flatten_random(
        ref, jnp.asarray(x, jnp.uint32), params.moduli, (lo, hi), 7, op=1,
        prune=prune,
    )
    g = trns.flatten_random(
        got, torch.as_tensor(x), params.moduli, (int(lo), int(hi)), 7, op=1,
        prune=prune,
    )
    _eq(r, g)


@pytest.mark.parametrize("n", [64, 16384])
def test_rescale_exact_equals_reference(n):
    """K = 1 at Params(64), K = 2 at n = 16384 (L = 4)."""
    params = F.Params.create(n)
    mods = params.moduli
    L = len(mods)
    ref = rrns.build_context(mods).device_context()
    got = trns.build_context(mods).device_context("cpu")
    rng = np.random.default_rng(n)
    x = rng.integers(0, 1 << 30, (3, L, 128)) % np.array(mods).reshape(L, 1)
    x[0, :, :4] = 0  # the floor-mode clamp and the round-to-r wrap edges
    Qm1 = params.Q - 1
    x[0, :, 4] = [Qm1 % p for p in mods]
    for rnd in (True, False):
        r = rrns.rescale_exact(ref, jnp.asarray(x, jnp.uint32), params.r, mods, rnd)
        g = trns.rescale_exact(got, torch.as_tensor(x), params.r, mods, rnd)
        _eq(r, g)


@pytest.mark.parametrize("n", [64, 512])
def test_negacyclic_mul_bits_equals_reference(n):
    params = F.Params.create(n)
    rng = np.random.default_rng(n + 1)
    a = rng.integers(0, params.r, (2, n))
    s = rng.integers(0, 2, (n,))
    r = jax.jit(rpoly.negacyclic_mul_bits, static_argnums=(2, 3))(
        jnp.asarray(a, jnp.uint32), jnp.asarray(s, jnp.uint32), params.mask_r,
        params.q_factors,
    )
    g = tpoly.negacyclic_mul_bits(
        torch.as_tensor(a), torch.as_tensor(s), params.mask_r, params.q_factors
    )
    _eq(r, g)
    # schoolbook check of the same product
    want = np.zeros(n, dtype=object)
    for i in range(n):
        for k in range(n):
            if s[k]:
                j = i + k
                want[j % n] += int(a[0, i]) * (1 if j < n else -1)
    np.testing.assert_array_equal(
        np.array([int(v) % params.r for v in want]), _np(g[0])
    )
    assert T.Params.create(n).q_factors == params.q_factors


def test_flatten_random_stacked_operands_equal_reference(rns64):
    """Both operands of a rotation step in one call (op=(0, 1), the
    twin's form) equal the JAX package's two calls, each with its op."""
    params, ref, got, x = rns64
    lo, hi = rrns.seed_words(jax.random.key(14))
    x2 = np.stack([x, x[::-1].copy()])
    g = trns.flatten_random(got, torch.as_tensor(x2), params.moduli, (int(lo), int(hi)), 5,
                            op=(0, 1))
    for op in (0, 1):
        r = rrns.flatten_random(ref, jnp.asarray(x2[op], jnp.uint32), params.moduli, (lo, hi),
                                5, op=op)
        _eq(r, g[op])


@pytest.mark.parametrize("prune", [0, 1])
def test_flatten_random_with_global_counters_equals_the_jax_package(rns64, prune):
    """The sharded rotation's mask counters gate*m + i1*m2 + idx*m2_loc + j
    (parallel/rotate_dist.blind_rotate_dist at (m1, m2) = (16, 32), rank 1
    of 2), given as c0, draw the JAX package's masks."""
    params, ref, got, _ = rns64
    L, m1, m2, D, idx = params.num_limbs, 16, 32, 2, 1
    m2l = m2 // D
    rng = np.random.default_rng(11)
    x = rng.integers(0, 1 << 30, (3, L, m1 * m2l)) % np.array(params.moduli).reshape(L, 1)
    g = np.arange(3)[:, None, None] * params.m
    c0 = (g + np.arange(m1)[None, :, None] * m2 + idx * m2l
          + np.arange(m2l)[None, None, :]).reshape(3, m1 * m2l)
    lo, hi = 0x0BADF00D, 0x5EED1234
    want = rrns.flatten_random(ref, jnp.asarray(x, jnp.uint32), params.moduli,
                               (jnp.uint32(lo), jnp.uint32(hi)), 9, op=1,
                               c0=jnp.asarray(c0, jnp.uint32), prune=prune)
    _eq(want, trns.flatten_random(got, torch.as_tensor(x), params.moduli, (lo, hi), 9, op=1,
                                  prune=prune, c0=torch.as_tensor(c0)))
