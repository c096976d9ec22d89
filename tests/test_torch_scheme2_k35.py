"""Scheme 2 at k = 3 and k = 5 in the port against the JAX package on the
CPU, and the rotation kernels' envelope. At k = 3, n = 64 (m = 2048, L = 3):
add_with_carry on two pairs, bit for bit, exact, with prune = 2 and
randomized (the JAX package's folded seed words given). At k = 5, n = 64
(m = 8192, L = 3): one rotation step equals the JAX package's in both
modes. The whole add_with_carry at k = 4 and k = 5, and the k = 5 key
through its seeded frame, are in tests/test_torch_scheme2_k4.py, _k5.py
and _k5_key.py (one file each keeps each under a minute). The envelope:
scheme 2 at k = 5, n = 4096 (m = 65536) is refused by the kernels' check
with a message that names m = 65536 and scheme 2's ring degree, without
building its key."""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# The twins issue many small ops: one thread each, or the parallel test
# workers oversubscribe the cores and run many times slower.
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from sgfhe_tpu.models import bootstrap as rbs  # noqa: E402
from sgfhe_tpu.models import scheme2 as rs2  # noqa: E402

import sgfhe_tpu_torch as T  # noqa: E402
from sgfhe_tpu_torch import interop  # noqa: E402
from sgfhe_tpu_torch.models import bootstrap as tbs  # noqa: E402
from sgfhe_tpu_torch.models import scheme2 as ts2  # noqa: E402
from sgfhe_tpu_torch.ops import fused  # noqa: E402

import torch_s2_parity as par  # noqa: E402


@pytest.fixture(scope="module")
def toy_k3():
    return par.setup(3, 30)


@pytest.mark.parametrize("mode", ["exact", "prune=2", "randomized"])
def test_k3_add_with_carry_equals_reference(toy_k3, mode):
    par.check_add_with_carry(toy_k3, mode)


@pytest.mark.parametrize("randomized", [False, True], ids=["exact", "randomized"])
def test_k5_rotation_step_equals_reference(randomized):
    """One rotation step at k = 5, n = 64 (m = 8192, L = 3) on a random
    canonical key slice and accumulators, through both packages."""
    params = rs2.Params.create(5, n=64)
    ctx = rs2.make_context(params)
    tp = interop.scheme2_params(params)
    tctx = ts2.make_context(tp, device="cpu")
    L, m, B, step = tp.num_limbs, tp.m, 4, 9
    assert (m, L, tp.r) == (8192, 3, 16384)
    rng = np.random.default_rng(5 + randomized)
    p = np.array(tp.moduli, dtype=np.int64).reshape(L, 1)
    a0 = rng.integers(0, 1 << 30, (B, L, m)) % p
    b0 = rng.integers(0, 1 << 30, (B, L, m)) % p
    ck = rng.integers(0, 1 << 30, (2 * L, 2, L, m)) % p
    ck_s = (ck << 32) // p
    u = rng.integers(0, 2 * m, B)
    seed2 = par.seed_words(jax.random.key(83), 3) if randomized else None
    step_fn = jax.jit(functools.partial(rbs._external_step, params, ctx, step_k=step))
    ref = step_fn(jnp.asarray(a0, jnp.uint32), jnp.asarray(b0, jnp.uint32),
                  jnp.asarray(ck, jnp.uint32), jnp.asarray(ck_s, jnp.uint32),
                  jnp.asarray(u, jnp.uint32),
                  None if seed2 is None else tuple(jnp.uint32(w) for w in seed2))
    got = tbs._external_step(tp, tctx, torch.as_tensor(a0), torch.as_tensor(b0),
                             torch.as_tensor(ck), torch.as_tensor(ck_s), torch.as_tensor(u),
                             seed2, step)
    for r, g in zip(ref, got):
        np.testing.assert_array_equal(np.asarray(r).astype(np.int64), g.numpy())


def test_envelope_names_scheme2_ring():
    """Scheme 2 at k = 5, n = 4096 builds its Params on the CPU with
    m = 65536 (L = l = 4); its 128 GiB key is never made: the kernels'
    check refuses the ring before a launch, with the bound on m and
    scheme 2's ring degree, and no scheme-1 bound on n."""
    params = T.Scheme2.Params.create(5, 4096)
    assert (params.m, params.num_limbs, params.num_digits) == (65536, 4, 4)
    with pytest.raises(ValueError) as err:
        fused.check_envelope(params)
    text = str(err.value)
    assert "m = 65536" in text and "m <= 32768" in text
    assert "scheme 2 at k = 5, n = 4096: m = 2^(k+5)·sqrt(n)" in text
    assert "n <=" not in text and "8n" not in text
    for plan in (fused.fwd_plan, fused.mac_plan):
        with pytest.raises(ValueError, match="m = 65536 exceeds") as err:
            plan(2, 4, params.m, 0)
        assert "n <=" not in str(err.value)
    fused.check_envelope(T.Scheme2.Params.create(5))  # m = 32768: inside
