"""The port's scheme 2 (sgfhe_tpu_torch/models/scheme2.py) against the JAX
package on the CPU: Params field for field (the paper's k = 1..5 at
n = 1024 and the toy n = 64), context tables, the exact q -> r switch (a
single-prime q through modmath.rescale, an RNS q through rescale_exact),
the mod-2^k product (helper-prime NTTs against the reference's Toeplitz
matmul), private and public encryption and the key's GSW rows from the
reference's own draws, bit for bit; port-made keys decrypt right."""

import dataclasses
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# The twins issue many small ops: one thread each, or the parallel test
# workers oversubscribe the cores and run many times slower.
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from sgfhe_tpu.models import scheme1 as rs1  # noqa: E402
from sgfhe_tpu.models import scheme2 as rs2  # noqa: E402
from sgfhe_tpu.ops import ntt as rntt  # noqa: E402
from sgfhe_tpu.ops import poly as rpoly  # noqa: E402
from sgfhe_tpu.ops import rns as rrns  # noqa: E402

from sgfhe_tpu_torch import interop  # noqa: E402
from sgfhe_tpu_torch.models import scheme1 as ts1  # noqa: E402
from sgfhe_tpu_torch.models import scheme2 as ts2  # noqa: E402
from sgfhe_tpu_torch.ops import ntt as tntt  # noqa: E402
from sgfhe_tpu_torch.ops import poly as tpoly  # noqa: E402
from sgfhe_tpu_torch.ops import rns as trns  # noqa: E402


def _eq(ref, got):
    np.testing.assert_array_equal(np.asarray(ref), interop.to_numpy(got))


def _t(x):
    return interop.tensor(np.asarray(x), "cpu")


def _signed(x):
    return torch.as_tensor(np.asarray(x).astype(np.int64))


def _q_contexts(params):
    """Only what public-key encryption and the q -> r switch read (plan_q,
    rns_q), for both packages: no length-m tables."""
    ref = types.SimpleNamespace(
        plan_q=rntt.build_plan(params.q_moduli, params.n),
        rns_q=rrns.build_context(params.q_moduli).device_context(),
    )
    port = types.SimpleNamespace(
        plan_q=tntt.build_plan(params.q_moduli, params.n, "cpu"),
        rns_q=trns.build_context(params.q_moduli).device_context("cpu"),
    )
    return ref, port


@pytest.fixture(scope="module", params=[1, 2], ids=["k1", "k2"])
def toy(request):
    """The toy n = 64 set of the JAX package's tests with its keys."""
    params = rs2.Params.create(request.param, n=64)
    ctx = rs2.make_context(params)
    sk = rs2.PrivateKey.create(params, jax.random.key(1))
    tp = interop.scheme2_params(params)
    return dict(params=params, ctx=ctx, sk=sk, tp=tp,
                tctx=ts2.make_context(tp, device="cpu"),
                tsk=interop.private_key(tp, np.asarray(sk.key), "cpu"))


@pytest.mark.parametrize("k,n", [(k, 1024) for k in range(1, 6)] + [(1, 64), (2, 64)])
def test_params_equal_reference(k, n):
    ref = rs2.Params.create(k, n)
    got = ts2.Params.create(k, n)
    assert ref.__dict__ == got.__dict__
    assert (ref.q, ref.Q, ref.DQ, ref.num_limbs, ref.num_digits, ref.mask_r) == (
        got.q, got.Q, got.DQ, got.num_limbs, got.num_digits, got.mask_r)
    assert interop.scheme2_params(ref) == got


def test_context_tables_equal(toy):
    ref, got = toy["ctx"], toy["tctx"]
    for r_plan, g_plan in ((ref.plan_Q, got.plan_Q), (ref.plan_q, got.plan_q)):
        assert r_plan.moduli == g_plan.moduli
        _eq(r_plan.pre_tw, g_plan.pre_tw)
        _eq(r_plan.post_tw, g_plan.post_tw)
        _eq(r_plan.mono_pow, g_plan.mono_pow)
    for r_rns, g_rns in ((ref.rns, got.rns), (ref.rns_q, got.rns_q)):
        for name in ("p", "inv_pj_val", "w_val", "w_shoup", "s_mod", "offset"):
            _eq(getattr(r_rns, name), getattr(g_rns, name))
    assert got.fused.moduli == toy["params"].moduli and got.device.type == "cpu"


@pytest.mark.parametrize("k,n", [(k, 1024) for k in range(1, 6)] + [(1, 64), (2, 64)])
def test_switch_q_to_r_equals_reference_and_oracle(k, n):
    params = rs2.Params.create(k, n)
    ref_ctx, port_ctx = _q_contexts(params)
    q = params.q
    rng = np.random.default_rng(100 + k)
    xs = [int(v) % q for v in rng.integers(0, min(q, 2**62), 48)]
    grid = 1 << (params.t - params.k - 5)
    for new_max in (params.r, params.r // grid):  # every round and floor boundary
        for t in rng.integers(0, new_max, 8):
            lo = (int(t) * q) // new_max
            xs += [lo % q, (lo + 1) % q, ((2 * int(t) + 1) * q // (2 * new_max)) % q]
    res = np.stack([np.array([v % p for v in xs], dtype=np.uint32) for p in params.q_moduli])
    tp = interop.scheme2_params(params)
    for new_max, rnd in ((params.r, True), (params.r // grid, False)):
        ref = rs2._switch_q_to_r(params, ref_ctx, jnp.asarray(res), new_max, rnd)
        got = ts1._switch_q_to_r(port_ctx, _t(res), new_max, rnd)
        _eq(ref, got)
        oracle = [((2 * v * new_max + q) // (2 * q) if rnd else v * new_max // q) % new_max
                  for v in xs]
        assert interop.to_numpy(got).tolist() == oracle


@pytest.mark.parametrize("k,n", [(1, 64), (2, 64), (1, 1024), (5, 1024)])
def test_mod_2k_product_equals_toeplitz(k, n):
    """The port multiplies by the key with helper-prime NTTs over q's
    primes; the JAX package's scheme 2 with a wrapping Toeplitz matmul."""
    params = rs2.Params.create(k, n)
    rng = np.random.default_rng(k * n)
    s = rng.integers(0, 2, n)
    a = rng.integers(0, params.r, (3, n))
    a[0] = params.r - 1  # the largest coefficients everywhere
    ref = rpoly.negacyclic_matmul_mask(
        jnp.asarray(a, jnp.uint32), rpoly.toeplitz_from_small(jnp.asarray(s)), params.mask_r)
    got = tpoly.negacyclic_mul_bits(torch.as_tensor(a), torch.as_tensor(s), params.mask_r,
                                    params.q_moduli)
    _eq(ref, got)


def test_private_encrypt_from_reference_draws(toy):
    """b = a·s + w + m·Dr, truncated, from the reference's own u-expansion
    and noise; the port's decrypt reads the reference's ciphertext."""
    params, sk = toy["params"], toy["sk"]
    key = jax.random.key(21)
    msg = np.array(jax.random.randint(jax.random.key(22), (params.n,), 0, 2**params.k))
    a_ref, b_ref = rs2.encrypt(sk, key, jnp.asarray(msg))
    k_u, k_w = jax.random.split(key)
    u = jax.random.bernoulli(k_u, 0.5, (params.n,)).astype(jnp.uint32)
    w_range = params.Dr // 8
    w = jax.random.randint(k_w, (params.n,), -w_range, w_range + 1, jnp.int32)
    a = rs2.deterministic_expand(params, u)
    _, b = ts2._encrypt_private_draws(toy["tp"], toy["tsk"].key, _t(a), _signed(w),
                                      torch.as_tensor(msg))
    _eq(b_ref, b)
    got = ts2.decrypt(toy["tsk"], _t(a_ref), _t(b_ref))
    _eq(rs2.decrypt(sk, a_ref, b_ref), got)
    np.testing.assert_array_equal(got.numpy(), msg)


def _pubkey_draws(params, key):
    """The reference PublicKey.create's draws (k0, e)."""
    k_u, k_e = jax.random.split(key)
    keys_u = jax.random.split(k_u, len(params.q_moduli))
    k0 = jnp.stack([jax.random.randint(keys_u[i], (params.n,), 0, p, dtype=jnp.int32)
                    for i, p in enumerate(params.q_moduli)])
    dq, rr = divmod(params.Dq, 512 * params.n)
    e_max = dq - (1 if rr == 0 else 0)
    return k0, jax.random.randint(k_e, (1, params.n), -e_max, e_max + 1, dtype=jnp.int32)


def _public_draws(params, key):
    """The reference's public-key encryption draws (u, w1, w2)."""
    k_u, k_w1, k_w2 = jax.random.split(key, 3)
    w1_max, w2_max = params.Dq // (64 * params.n), params.Dq // 512
    return (jax.random.randint(k_u, (1, params.n), -1, 2, dtype=jnp.int32),
            jax.random.randint(k_w1, (1, params.n), -w1_max, w1_max + 1, jnp.int32),
            jax.random.randint(k_w2, (1, params.n), -w2_max, w2_max + 1, jnp.int32))


@pytest.mark.parametrize("k,n", [(1, 64), (2, 64), (1, 1024)])
def test_public_key_and_encrypt_from_reference_draws(k, n):
    """A single-prime q (toy) and an RNS q (n = 1024)."""
    params = rs2.Params.create(k, n)
    ref_ctx, port_ctx = _q_contexts(params)
    tp = interop.scheme2_params(params)
    sk = rs2.PrivateKey.create(params, jax.random.key(5))
    tsk = interop.private_key(tp, np.asarray(sk.key), "cpu")
    # jitted: the reference's eager NTTs compile op by op
    pk = rs2.PublicKey(params, *jax.jit(
        lambda key: dataclasses.astuple(rs2.PublicKey.create(ref_ctx, sk, key))[1:]
    )(jax.random.key(6)))
    k0, e = _pubkey_draws(params, jax.random.key(6))
    k1 = ts1._pubkey_k1(port_ctx, tsk.key, _t(k0), _signed(e))
    _eq(pk.k0, _t(k0))
    _eq(pk.k1, k1)

    msg = np.array(jax.random.randint(jax.random.key(7), (n,), 0, 2**k))
    a_ref, b_ref = jax.jit(lambda key, m: rs2.encrypt(pk, ref_ctx, key, m))(
        jax.random.key(8), jnp.asarray(msg))
    u, w1, w2 = (_signed(x) for x in _public_draws(params, jax.random.key(8)))
    tpk = interop.public_key(tp, np.asarray(pk.k0), np.asarray(pk.k1), "cpu")
    assert isinstance(tpk, ts2.PublicKey)
    got = ts1._encrypt_public_draws(tp, port_ctx, tpk.k0, tpk.k1, u, w1, w2,
                                    torch.as_tensor(msg), k + 6)
    _eq(a_ref, got.a)
    _eq(b_ref, got.b)
    np.testing.assert_array_equal(ts2.decrypt(tsk, got.a, got.b).numpy(), msg)


def test_bootstrap_key_rows_from_reference_draws(toy):
    """The GSW rows from the reference's draws equal its key, companions
    included (one chunk of key indices at n = 64)."""
    params, ctx, sk = toy["params"], toy["ctx"], toy["sk"]
    key = jax.random.key(2)
    ref = rs2.BootstrapKey.create(ctx, sk, key)
    n, m, L = params.n, params.m, params.num_limbs
    rows = 2 * params.num_digits
    assert min(rs2.BootstrapKey.KEY_CHUNK, n) == n
    k_a, k_e = jax.random.split(key)
    a = rs1._uniform_residues(jax.random.fold_in(k_a, 0), (n, rows, L, m), params.moduli)
    e = jax.random.randint(jax.random.fold_in(k_e, 0), (n, rows, 1, m), -params.tau,
                           params.tau + 1, dtype=jnp.int32)
    tctx, s = toy["tctx"], toy["tsk"].key
    s_rns, s_hat = ts1._key_rns(tctx, s, m, L)
    hat = ts1._gsw_hat(toy["tp"], tctx, s_rns, s_hat, s, _t(a), _signed(e))
    _eq(ref.hat, hat)
    _eq(ref.hat_shoup, ts1._shoup_companion(hat, tctx.plan_Q.p))


def test_port_keys_encrypt_decrypt(toy, monkeypatch):
    """Port-made keys, private and public, round trip; the bootstrap key
    built in several chunks has the reference's layout."""
    tp, tctx = toy["tp"], toy["tctx"]
    g = torch.Generator().manual_seed(31)
    sk = ts2.PrivateKey.create(tp, g, device="cpu")
    pk = ts2.PublicKey.create(tctx, sk, g)
    assert pk.k0.shape == pk.k1.shape == (len(tp.q_moduli), tp.n)
    msg = torch.randint(0, 2**tp.k, (tp.n,), generator=g)
    for key_args in ((sk,), (pk, tctx)):
        a, b = ts2.encrypt(*key_args, g, msg)
        assert torch.equal(ts2.decrypt(sk, a, b), msg)
    row_bytes = 2 * tp.num_digits * 2 * tp.num_limbs * tp.m * 8
    monkeypatch.setattr(ts1, "KEY_CHUNK_BYTES", 24 * row_bytes)
    bk = ts2.BootstrapKey.create(tctx, sk, g)
    shape = (tp.n, 2 * tp.num_digits, 2, tp.num_limbs, tp.m)
    assert bk.hat.shape == bk.hat_shoup.shape == shape and bk.hat.dtype == torch.int32
    _eq(ts1._shoup_companion(bk.hat.long(), tctx.plan_Q.p), bk.hat_shoup)


def test_module_serves_bootstrap2_and_wideint():
    """`Scheme2.add_with_carry` and the other functional-bootstrap names,
    and `Scheme2.wideint`, as the reference's module serves them."""
    import sgfhe_tpu_torch as T
    from sgfhe_tpu_torch.models import bootstrap2, wideint

    assert ts2._BOOTSTRAP2_EXPORTS == rs2._BOOTSTRAP2_EXPORTS
    for name in sorted(rs2._BOOTSTRAP2_EXPORTS):
        assert getattr(T.Scheme2, name) is getattr(bootstrap2, name)
        assert getattr(T.Scheme2, name) is getattr(T.Scheme2Boot, name)
    assert T.Scheme2.wideint is wideint
    with pytest.raises(AttributeError, match="no attribute"):
        T.Scheme2.not_a_name  # noqa: B018
