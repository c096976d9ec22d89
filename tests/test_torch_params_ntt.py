"""The port's Params, NTT plans, NTT twins and the CUDA kernels' tables
against the JAX package, bit for bit, on the CPU."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# The twins issue many small ops: one thread each, or the parallel test
# workers oversubscribe the cores and run many times slower.
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import sgfhe_tpu as F  # noqa: E402
from sgfhe_tpu.ops import fused as rfused  # noqa: E402
from sgfhe_tpu.ops import ntt as rntt  # noqa: E402
from sgfhe_tpu.utils import primes as rpr  # noqa: E402

import sgfhe_tpu_torch as T  # noqa: E402
from sgfhe_tpu_torch.ops import fused as tfused  # noqa: E402
from sgfhe_tpu_torch.ops import ntt as tntt  # noqa: E402


def _np(t):
    return t.cpu().numpy()


@pytest.mark.parametrize("n", [64, 128, 256, 512, 1024, 2048, 4096, 8192, 16384])
def test_params_equal_reference(n):
    ref = F.Params.create(n)
    got = T.Params.create(n)
    for field in ("n", "r", "q", "t", "m", "moduli", "Dr", "Dq", "q_moduli"):
        assert getattr(got, field) == getattr(ref, field), field
    assert got.q_factors == ref.q_factors
    assert got.Q == ref.Q and got.gadget_weights == ref.gadget_weights


@pytest.fixture(scope="module", params=[512, 4096])
def plans(request):
    m = request.param
    mods = rpr.find_rns_primes(2 * m, 1 << 54, 1 << 56, 2)
    return m, mods, rntt.build_plan(mods, m), tntt.build_plan(mods, m, "cpu")


def test_build_plan_tables_equal(plans):
    m, mods, ref, got = plans
    assert got.moduli == ref.moduli
    pairs = [
        (ref.p, got.p), (ref.mu, got.mu),
        (ref.pre_tw, got.pre_tw), (ref.pre_tw_s, got.pre_tw_s),
        (ref.post_tw, got.post_tw), (ref.post_tw_s, got.post_tw_s),
        (ref.mono_pow, got.mono_pow), (ref.mono_pow_s, got.mono_pow_s),
    ]
    for rs, gs in zip(ref.fwd_tw + ref.inv_tw, got.fwd_tw + got.inv_tw):
        pairs += list(zip(rs, gs))
    for r, g in pairs:
        np.testing.assert_array_equal(np.asarray(r).astype(np.int64), _np(g))


def test_ntt_twins_equal_reference(plans):
    m, mods, ref, got = plans
    rng = np.random.default_rng(m)
    L = len(mods)
    p = np.array(mods).reshape(L, 1)
    x = rng.integers(0, 1 << 30, (3, L, m)) % p
    u = rng.integers(0, 2 * m, (3,))
    jx = jnp.asarray(x, jnp.uint32)
    tx = torch.as_tensor(x)
    r_hat = jax.jit(rntt.ntt_fwd)(ref, jx)
    g_hat = tntt.ntt_fwd(got, tx)
    np.testing.assert_array_equal(np.asarray(r_hat).astype(np.int64), _np(g_hat))
    np.testing.assert_array_equal(
        np.asarray(jax.jit(rntt.ntt_inv)(ref, jx)).astype(np.int64),
        _np(tntt.ntt_inv(got, tx)),
    )
    np.testing.assert_array_equal(_np(tntt.ntt_inv(got, g_hat)), x)
    r_mono = jax.jit(rntt.monomial_mul_hat)(ref, r_hat, jnp.asarray(u, jnp.uint32))
    g_mono = tntt.monomial_mul_hat(got, g_hat, torch.as_tensor(u))
    np.testing.assert_array_equal(np.asarray(r_mono).astype(np.int64), _np(g_mono))


def _kernel_ntt_fwd(x, tab, p, m):
    """numpy emulation of csrc/rotate.cu ntt_fwd_smem's index math and lazy
    bounds (every value < 4p) on the kernel's compact twiddle table."""
    logm = m.bit_length() - 1
    x = x.astype(np.uint64).copy()
    j = np.arange(m // 2)
    for s in range(logm):
        lg_len = logm - 1 - s
        blk = j >> lg_len
        i0 = (blk << (lg_len + 1)) + (j & ((1 << lg_len) - 1))
        i1 = i0 + (1 << lg_len)
        w, ws = tab[0][(1 << s) + blk], tab[1][(1 << s) + blk]
        u = np.where(x[i0] >= 2 * p, x[i0] - 2 * p, x[i0])
        v = (x[i1] * w - ((x[i1] * ws) >> np.uint64(32)) * p) & np.uint64(0xFFFFFFFF)
        assert (u < 2 * p).all() and (v < 2 * p).all()
        x[i0], x[i1] = u + v, u + 2 * p - v
        assert (x < 4 * p).all()
    return x % p


def _kernel_ntt_inv(x, tab, p, m):
    """numpy emulation of ntt_inv_smem + the post-twist."""
    logm = m.bit_length() - 1
    x = x.astype(np.uint64).copy()
    j = np.arange(m // 2)
    for s in range(logm):
        h = 1 << s
        off = j & (h - 1)
        i0 = ((j >> s) << (s + 1)) + off
        i1 = i0 + h
        w, ws = tab[2][h + off], tab[3][h + off]
        a = np.where(x[i0] >= 2 * p, x[i0] - 2 * p, x[i0])
        t = (x[i1] * w - ((x[i1] * ws) >> np.uint64(32)) * p) & np.uint64(0xFFFFFFFF)
        x[i0], x[i1] = a + t, a + 2 * p - t
        assert (x < 4 * p).all()
    return (x * tab[4]) % p


def test_kernel_tables_match_reference(plans):
    """The kernels' compact tables hold what the JAX package's full-width
    fused tables and ψ-power ladder hold, and the kernels' NTT index math
    (emulated in numpy) reproduces the plan's transforms."""
    m, mods, ref, got = plans
    ft = rfused.build_fused(ref)
    tabs = tfused.build_tables_host(mods, m)
    fwd_full = np.asarray(ft.fwd_full).astype(np.uint64)
    inv_full = np.asarray(ft.inv_full).astype(np.uint64)
    S = m.bit_length() - 1
    idx = np.arange(m)
    for s in range(S):
        blen = m >> s
        for li in range(len(mods)):
            blocks = tabs[li, 0, (1 << s) + idx // blen]
            np.testing.assert_array_equal(blocks, fwd_full[s, li])
            b_pos = ((idx >> s) & 1) == 1
            np.testing.assert_array_equal(
                tabs[li, 2, (1 << s) + idx[b_pos] % (1 << s)], inv_full[s, li, b_pos]
            )
    # x^u at hat position idx is one gather of pw[(2 br(idx) + 1) u mod 2m]
    mono = np.asarray(ref.mono_pow).astype(np.uint64)
    br = tntt._bit_reverse_indices(m)
    rng = np.random.default_rng(7)
    for u in list(rng.integers(0, 2 * m, 6)) + [0, 2 * m - 1]:
        for li, p in enumerate(mods):
            ladder = np.ones(m, dtype=np.uint64)
            for b in range(mono.shape[0]):
                if (u >> b) & 1:
                    ladder = ladder * mono[b, li] % np.uint64(p)
            pw = tabs[li, 6:8].reshape(-1)
            np.testing.assert_array_equal(pw[((2 * br + 1) * u) % (2 * m)], ladder)
            assert (tabs[li, 8:10].reshape(-1) == (pw << np.uint64(32)) // np.uint64(p)).all()
    x = rng.integers(0, 1 << 30, (len(mods), m)) % np.array(mods).reshape(-1, 1)
    r_hat = np.asarray(jax.jit(rntt.ntt_fwd)(ref, jnp.asarray(x, jnp.uint32))).astype(np.uint64)
    for li, p in enumerate(mods):
        p = np.uint64(p)
        hat = _kernel_ntt_fwd(x[li], tabs[li], p, m)
        np.testing.assert_array_equal(hat, r_hat[li])
        np.testing.assert_array_equal(_kernel_ntt_inv(hat, tabs[li], p, m), x[li])
