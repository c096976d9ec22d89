"""The CUDA rotation kernels (the step pair and rotate_resident) against
the twin or their plain versions, bit for bit, on a card.

These tests need a CUDA device (the kernels have no CPU mode) and skip
without one. They import neither JAX nor the JAX package, so they run on a
machine that has only PyTorch:

    python -m pytest tests/test_torch_kernels.py --noconftest -q
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# The twins issue many small ops: one thread each, or the parallel test
# workers oversubscribe the cores and run many times slower.
torch.set_num_threads(1)

import sgfhe_tpu_torch as T  # noqa: E402
from sgfhe_tpu_torch.models import bootstrap as tbs  # noqa: E402
from sgfhe_tpu_torch.ops import fused as tfused  # noqa: E402
from sgfhe_tpu_torch.ops import modmath as mm  # noqa: E402
from sgfhe_tpu_torch.ops import rns as trns  # noqa: E402
from sgfhe_tpu_torch.utils import primes  # noqa: E402


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def _twin_route(params, device):
    """Stands in for models/bootstrap._rotation_route: the twin on any device."""
    return "plain"


@pytest.mark.cuda
@pytest.mark.parametrize("prune", [0, 1, 2])
@pytest.mark.parametrize("seed2", [None, (7, 8)], ids=["exact", "randomized"])
def test_kernels_equal_twin_on_card(monkeypatch, prune, seed2):
    """Every mode of the step kernels against the twin at Params(64) with
    port-made keys."""
    dev = _card()
    params = T.Params.create(64)
    ctx = T.make_context(params, device=dev)
    g = torch.Generator().manual_seed(3)
    sk = T.PrivateKey.create(params, g, device=dev)
    bk = T.BootstrapKey.create(ctx, sk, g)
    rng = np.random.default_rng(9)
    B, L, m = 16, params.num_limbs, params.m
    p = np.array(params.moduli).reshape(L, 1)
    ua = torch.as_tensor(rng.integers(0, 2 * m, (B, params.n)), device=dev)
    a0 = torch.as_tensor(rng.integers(0, 1 << 30, (B, L, m)) % p, device=dev)
    b0 = torch.as_tensor(rng.integers(0, 1 << 30, (B, L, m)) % p, device=dev)
    with monkeypatch.context() as mp:
        mp.setattr(tbs, "_rotation_route", _twin_route)
        want = tbs.blind_rotate(params, ctx, bk.hat, bk.hat_shoup, ua, a0, b0, seed2, prune)
    before = tfused.flatten_ntt_fwd.launches, tfused.mac_rotate_ntt_inv.launches
    got = tfused.blind_rotate_steps(ctx, bk.hat, ua, a0, b0, seed2, prune)
    torch.cuda.synchronize()
    after = tfused.flatten_ntt_fwd.launches, tfused.mac_rotate_ntt_inv.launches
    assert after == (before[0] + params.n, before[1] + params.n)
    for w, gt in zip(want, got):
        assert torch.equal(w, gt)


@pytest.mark.cuda
@pytest.mark.parametrize(
    "prune,seed2,big", [(0, None, False), (1, None, False), (2, None, False),
                        (0, (7, 8), False), (1, (7, 8), False), (0, None, True)],
    ids=["exact", "prune1", "prune2", "randomized", "randomized-prune1", "near-2^29"])
def test_resident_kernel_equals_plain_on_card(prune, seed2, big):
    """rotate_resident (one launch for all n steps) against its plain
    version at Params(64) with port-made keys, in every mode, on a batch
    whose last gate tile is partial (and on near-2^29 moduli with l = 3)."""
    dev = _card()
    params = T.Params.create(64)
    if big:
        mods = primes.find_rns_primes(2 * params.m, 1 << 86, (1 << 87) - 1, 3)
        params = dataclasses.replace(params, moduli=mods)
    ctx = T.make_context(params, device=dev)
    g = torch.Generator().manual_seed(4)
    sk = T.PrivateKey.create(params, g, device=dev)
    bk = T.BootstrapKey.create(ctx, sk, g)
    rng = np.random.default_rng(11)
    B, L, m = 7, params.num_limbs, params.m
    p = np.array(params.moduli).reshape(L, 1)
    ua = torch.as_tensor(rng.integers(0, 2 * m, (B, params.n)), device=dev)
    a0 = torch.as_tensor(rng.integers(0, 1 << 30, (B, L, m)) % p, device=dev)
    b0 = torch.as_tensor(rng.integers(0, 1 << 30, (B, L, m)) % p, device=dev)
    want = tfused.blind_rotate_fused_plain(ctx, bk.hat, ua, a0, b0, seed2, prune)
    for gates in (None, 3):
        before = tfused.blind_rotate_fused.launches
        got = tfused.blind_rotate_fused(ctx, bk.hat, ua, a0, b0, seed2, prune, gates)
        torch.cuda.synchronize()
        assert tfused.blind_rotate_fused.launches == before + 1
        for w, gt in zip(want, got):
            assert torch.equal(w, gt), gates


@pytest.mark.cuda
def test_bootstrap_batch_on_card_truth_tables():
    dev = _card()
    params = T.Params.create(64)
    ctx = T.make_context(params, device=dev)
    g = torch.Generator().manual_seed(5)
    sk = T.PrivateKey.create(params, g, device=dev)
    bk = T.BootstrapKey.create(ctx, sk, g)
    msg = torch.randint(0, 2, (params.n,), generator=g)
    bits = T.split_ciphertext(T.encrypt(sk, g, msg)).lwe
    before = trns.rescale_exact.launches
    out = T.bootstrap_batch(params, ctx, bk.hat, bk.hat_shoup,
                            T.LWE(bits.a[0::2], bits.b[0::2]),
                            T.LWE(bits.a[1::2], bits.b[1::2]))
    # the switch: one kernel launch for a and one for b of each answer
    assert trns.rescale_exact.launches == before + 6
    y1, y2 = msg[0::2].bool().to(dev), msg[1::2].bool().to(dev)
    for lwe, want in zip(out, (y1 & y2, y1 | y2, y1 ^ y2)):
        assert torch.equal(T.decrypt_bit(sk, T.EncryptedBit(lwe)), want)


def _ragged_batch(L, m, prune):
    """A batch whose last gate tile is partial under the launch plan."""
    for B in range(2, 200):
        g = tfused.mac_plan(B, L, m, prune).gates
        if g > 1 and B % g:
            return B
    return 2


@pytest.mark.cuda
@pytest.mark.parametrize("L,m", [(3, 4096), (2, 8192), (3, 8192), (4, 4096),
                                 (2, 1024), (3, 2048), (4, 16384)])
@pytest.mark.parametrize("ragged", [False, True])
def test_step_kernels_equal_plain_on_card(L, m, ragged):
    """One step of each kernel against its plain version on random
    canonical inputs and a random key slice, near-2^29 moduli, every prune,
    exact and randomized flatten; B = 1, or a batch whose last gate tile
    is partial."""
    dev = _card()
    mods = primes.find_rns_primes(2 * m, 1 << (29 * L - 2), (1 << (29 * L - 1)) - 1, L)
    params = dataclasses.replace(T.Params.create(m // 8), moduli=mods)
    ctx = T.make_context(params, device=dev)
    rng = np.random.default_rng(L * m)
    p = np.array(mods, dtype=np.int64).reshape(L, 1)

    def canon(shape):
        return rng.integers(0, 1 << 30, shape) % p

    def on_card(a):
        return mm.bits32(torch.as_tensor(a, device=dev))

    key_hat = on_card(canon((1, 2 * L, 2, L, m)))
    for prune in range(L):
        B = _ragged_batch(L, m, prune) if ragged else 1
        acc = on_card(canon((2, B, L, m)))
        u = on_card(rng.integers(0, 2 * m, (B,)))
        for seed2 in (None, (0x12345678, 0x9ABCDEF0)):
            got = tfused.flatten_ntt_fwd(ctx, acc, 3, seed2, prune)
            want = tfused.flatten_ntt_fwd_plain(ctx, acc, 3, seed2, prune)
            assert torch.equal(got, want), (prune, seed2)
        got = tfused.mac_rotate_ntt_inv(ctx, want, key_hat, 0, u, prune)
        exp = tfused.mac_rotate_ntt_inv_plain(ctx, want, key_hat, 0, u, prune)
        assert torch.equal(got, exp), prune


@pytest.mark.cuda
@pytest.mark.parametrize("k", [1, 2])
def test_scheme2_add_with_carry_on_card_equals_twin(monkeypatch, k):
    """Scheme 2 at the toy n = 64 with port-made keys: the k = 1 key (4
    MiB) takes rotate_resident, one launch a rotation, the k = 2 key (18
    MiB) the step pair with w-multiplies;
    the kernels' output equals the twin's in deterministic and randomized
    mode and decrypts right."""
    dev = _card()
    S2, B2 = T.Scheme2, T.Scheme2Boot
    params = S2.Params.create(k, 64)
    ctx = S2.make_context(params, device=dev)
    g = torch.Generator().manual_seed(10 + k)
    sk = S2.PrivateKey.create(params, g, device=dev)
    bk = S2.BootstrapKey.create(ctx, sk, g)
    resident = k == 1
    assert tbs._rotation_route(params, dev) == ("resident" if resident else "wmul")
    x = torch.randint(0, 2**k, (params.n,), generator=g)
    y = torch.randint(0, 2**k, (params.n,), generator=g)
    lx = B2.split_ciphertext(params, *S2.encrypt(sk, g, x))
    ly = B2.split_ciphertext(params, *S2.encrypt(sk, g, y))
    z = (x + y).to(dev)
    for seed2 in (None, (0x12345678, 0x9ABCDEF0)):
        before = tfused.blind_rotate_fused.launches, tfused.flatten_ntt_fwd.launches
        got = B2._add_with_carry(params, ctx, bk, lx, ly, None, seed2)
        after = tfused.blind_rotate_fused.launches, tfused.flatten_ntt_fwd.launches
        assert after == ((before[0] + 1, before[1]) if resident
                         else (before[0], before[1] + params.n))
        with monkeypatch.context() as mp:
            mp.setattr(tbs, "_rotation_route", _twin_route)
            want = B2._add_with_carry(params, ctx, bk, lx, ly, None, seed2)
        for w, gt in zip(want, got):
            assert torch.equal(w.a, gt.a) and torch.equal(w.b, gt.b)
        assert torch.equal(B2.decrypt_lwe(sk, got[0]), z % 2**k)
        assert torch.equal(B2.decrypt_lwe(sk, got[1]), z // 2**k)


@pytest.mark.cuda
def test_wideint_add_at_k4_on_card_equals_plain(monkeypatch):
    """Scheme 2 at k = 4 (L = 4, m = 4096 at the toy n = 64): one add_wide
    of W = 1 digit through the kernels equals the plain versions' output in
    deterministic and randomized mode and decrypts right."""
    from sgfhe_tpu_torch.models import wideint as twi

    dev = _card()
    S2 = T.Scheme2
    params = S2.Params.create(4, 64)
    ctx = S2.make_context(params, device=dev)
    g = torch.Generator().manual_seed(14)
    sk = S2.PrivateKey.create(params, g, device=dev)
    bk = S2.BootstrapKey.create(ctx, sk, g)
    xv, yv = np.array([15, 7, 0, 9]), np.array([15, 9, 0, 3])
    xs, ys = twi.encrypt_wide(sk, g, xv, 1), twi.encrypt_wide(sk, g, yv, 1)
    for seeds in (None, [(0x12345678, 0x9ABCDEF0)]):
        before = tfused.flatten_ntt_fwd.launches
        got = twi._add_wide(params, ctx, bk, xs, ys, seeds)
        assert tfused.flatten_ntt_fwd.launches == before + params.n
        with monkeypatch.context() as mp:
            mp.setattr(tbs, "_rotation_route", _twin_route)
            want = twi._add_wide(params, ctx, bk, xs, ys, seeds)
        for w, gt in zip(want, got):
            assert torch.equal(w.a, gt.a) and torch.equal(w.b, gt.b)
        np.testing.assert_array_equal(twi.decrypt_wide(sk, got), xv + yv)
