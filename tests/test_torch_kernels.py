"""The CUDA rotation kernels against the twin, bit for bit, on a card.

These tests need a CUDA device (the kernels have no CPU mode) and skip
without one. They import neither JAX nor the JAX package, so they run on a
machine that has only PyTorch:

    python -m pytest tests/test_torch_kernels.py --noconftest -q
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# The twins issue many small ops: one thread each, or the parallel test
# workers oversubscribe the cores and run many times slower.
torch.set_num_threads(1)

import sgfhe_tpu_torch as T  # noqa: E402
from sgfhe_tpu_torch.models import bootstrap as tbs  # noqa: E402
from sgfhe_tpu_torch.ops import fused as tfused  # noqa: E402


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize(
    "prune,seed2,carry",
    [(0, None, True), (0, None, False), (1, None, False), (2, None, False),
     (0, (7, 8), True), (1, (7, 8), False)],
)
def test_kernels_equal_twin_on_card(prune, seed2, carry):
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
    want = tbs.blind_rotate(params, ctx, bk.hat, bk.hat_shoup, ua, a0, b0,
                            seed2, prune, plain=True)
    before = tfused.flatten_ntt_fwd.launches, tfused.mac_rotate_ntt_inv.launches
    got = tfused.blind_rotate_steps(ctx, bk.hat, bk.hat_shoup, ua, a0, b0,
                                    seed2, prune, carry=carry)
    torch.cuda.synchronize()
    after = tfused.flatten_ntt_fwd.launches, tfused.mac_rotate_ntt_inv.launches
    assert after == (before[0] + params.n, before[1] + params.n)
    for w, gt in zip(want, got):
        assert torch.equal(w, gt)


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
    out = T.bootstrap_batch(params, ctx, bk.hat, bk.hat_shoup,
                            T.LWE(bits.a[0::2], bits.b[0::2]),
                            T.LWE(bits.a[1::2], bits.b[1::2]))
    y1, y2 = msg[0::2].bool().to(dev), msg[1::2].bool().to(dev)
    for lwe, want in zip(out, (y1 & y2, y1 | y2, y1 ^ y2)):
        assert torch.equal(T.decrypt_bit(sk, T.EncryptedBit(lwe)), want)
