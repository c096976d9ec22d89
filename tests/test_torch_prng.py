"""The JAX package's PRNG streams rebuilt in the port without JAX, against
`jax.random` on the CPU: `prng_expand` (the u-expansion of space-optimal
ciphertexts), the key streams of ops/prg.py (split, fold_in, bits,
randint with its uint32 wraps, chunk offsets) and the a-column streams of
the seeded bootstrap keys (stream 1 one-shot, stream 2 chunked)."""

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
from sgfhe_tpu.models import scheme1 as rs1  # noqa: E402
from sgfhe_tpu.models import scheme2 as rs2  # noqa: E402
from sgfhe_tpu.utils import prng as rprng  # noqa: E402

import sgfhe_tpu_torch as T  # noqa: E402
from sgfhe_tpu_torch import interop  # noqa: E402
from sgfhe_tpu_torch.models import scheme1 as ts1  # noqa: E402
from sgfhe_tpu_torch.ops import prg  # noqa: E402
from sgfhe_tpu_torch.utils import prng as tprng  # noqa: E402


def _key(k) -> torch.Tensor:
    return torch.as_tensor(np.asarray(jax.random.key_data(k)).astype(np.int64))


@pytest.mark.parametrize("n", [64, 512, 1024])
@pytest.mark.parametrize("batch", [(), (3,), (2, 2)], ids=["single", "batch3", "batch2x2"])
def test_prng_expand_equals_reference(n, batch):
    bits = np.random.default_rng(n + len(batch)).integers(0, 2, batch + (n,)).astype(np.uint32)
    t = F.Params.create(n).t
    for factor in (t + 1, 32):
        want = np.asarray(rprng.prng_expand(jnp.asarray(bits), factor))
        got = tprng.prng_expand(torch.as_tensor(bits.astype(np.int64)), factor)
        np.testing.assert_array_equal(want, got.numpy())


def test_deterministic_expand_both_schemes():
    u = np.random.default_rng(4).integers(0, 2, 64).astype(np.uint32)
    p1, p2 = F.Params.create(64), rs2.Params.create(2, n=64)
    tu = torch.as_tensor(u.astype(np.int64))
    np.testing.assert_array_equal(np.asarray(F.deterministic_expand(p1, jnp.asarray(u))),
                                  T.deterministic_expand(p1, tu).numpy())
    np.testing.assert_array_equal(np.asarray(rs2.deterministic_expand(p2, jnp.asarray(u))),
                                  T.Scheme2.deterministic_expand(interop.scheme2_params(p2),
                                                                 tu).numpy())


def test_reference_space_optimal_ciphertext_decrypts_in_port():
    """A space-optimal private ciphertext of the JAX package normalizes to
    its own a in the port and decrypts right (57.8% before the port drew
    the reference's stream)."""
    params = F.Params.create(64)
    sk = F.PrivateKey.create(params, jax.random.key(1))
    msg = np.random.default_rng(5).integers(0, 2, params.n).astype(bool)
    opt = F.encrypt_optimal(sk, jax.random.key(5), jnp.asarray(msg))
    ct = T.normalize_ciphertext(T.PrivateEncryptedCiphertext(
        params, torch.as_tensor(np.array(opt.u)).to(torch.uint8),
        torch.as_tensor(np.array(opt.v)).to(torch.uint8)))
    ref = F.normalize_ciphertext(opt)
    np.testing.assert_array_equal(np.asarray(ref.rlwe.a), interop.to_numpy(ct.rlwe.a))
    tsk = interop.private_key(params, np.asarray(sk.key), "cpu")
    np.testing.assert_array_equal(T.decrypt(tsk, ct).numpy(), msg)


def test_key_split_and_fold_in():
    k = jax.random.key(5)
    for num in (1, 2, 3, 7):
        np.testing.assert_array_equal(np.asarray(jax.random.key_data(jax.random.split(k, num))),
                                      prg.key_split(_key(k), num).numpy())
    for w in (0, 1, 77, 2**31, 2**32 - 1):
        np.testing.assert_array_equal(np.asarray(jax.random.key_data(jax.random.fold_in(k, w))),
                                      prg.key_fold_in(_key(k), w).numpy())
    # batched keys: (2, 2) keys each folding its own word, each splitting
    ks = jax.random.split(k, 2)
    words = np.array([9, 2**32 - 5])
    want = np.stack([jax.random.key_data(jax.random.fold_in(ks[i], int(w)))
                     for i, w in enumerate(words)])
    np.testing.assert_array_equal(want, prg.key_fold_in(_key(ks), torch.as_tensor(words)).numpy())
    want = np.stack([jax.random.key_data(jax.random.split(ks[i], 3)) for i in range(2)])
    np.testing.assert_array_equal(want, prg.key_split(_key(ks), 3).numpy())


def test_random_bits32():
    k = jax.random.key(11)
    want = np.asarray(jax.random.bits(k, (6, 35), jnp.uint32))
    np.testing.assert_array_equal(want, prg.random_bits32(_key(k), (6, 35)).numpy())
    np.testing.assert_array_equal(want.reshape(-1)[40:70],
                                  prg.random_bits32(_key(k), (30,), offset=40).numpy())


P1 = 452198401  # a modulus of Params(64)


@pytest.mark.parametrize("lo,hi", [
    (0, 2), (0, 2**16 - 1), (0, 2**16), (0, 2**16 + 1), (0, 1784833), (0, P1), (0, 2**30),
    (-1024, 1025), (-5, 3), (-(2**20), 2**20 + 1), (7, 7),
])
def test_randint_equals_reference(lo, hi):
    """Spans 2, 2^16 - 1 and 2^16 keep the high draw; above 2^16 the
    uint32 multiplier wraps to 0 and it drops out."""
    k = jax.random.key(lo * 31 + hi)
    want = np.asarray(jax.random.randint(k, (4, 6, 3, 16), lo, hi, dtype=jnp.int32))
    np.testing.assert_array_equal(want, prg.randint(_key(k), (4, 6, 3, 16), lo, hi).numpy())
    flat = want.reshape(-1)
    got = prg.randint(_key(k), (2, 3, 16), lo, hi, offset=2 * 3 * 3 * 16)
    np.testing.assert_array_equal(flat[288:384], got.numpy().reshape(-1))


def test_uniform_residues_stream_1():
    """Scheme 1's one-shot a-column: any chunk of key indices equals the
    slice of the JAX package's `_uniform_residues`."""
    params = F.Params.create(64)
    k_a = jax.random.key(9)
    rows, L, m = 2 * params.num_digits, params.num_limbs, params.m
    want = np.asarray(rs1._uniform_residues(k_a, (params.n, rows, L, m), params.moduli))
    seed = np.asarray(jax.random.key_data(k_a))
    for start, stop in ((0, params.n), (5, 41)):
        np.testing.assert_array_equal(
            want[start:stop], ts1._a_column(params, seed, start, stop, 1, "cpu").numpy())


def test_uniform_residues_stream_2_chunk_chain():
    """Scheme 2's chunked a-column: chunk c of 128 key indices draws from
    fold_in(k_a, c), whatever the builder's own chunks (c = 0..3 at a small
    ring, since a key at n = 64 has one chunk only)."""
    tp = interop.scheme2_params(rs2.Params.create(1, n=64))
    small = dataclasses.replace(tp, n=512, m=16)
    rows, L = 2 * small.num_digits, small.num_limbs
    k_a = jax.random.key(13)
    want = np.concatenate([
        np.asarray(rs1._uniform_residues(jax.random.fold_in(k_a, c), (128, rows, L, 16),
                                         small.moduli)) for c in range(4)])
    seed = np.asarray(jax.random.key_data(k_a))
    for start, stop in ((0, 512), (100, 300), (128, 256), (383, 385)):
        np.testing.assert_array_equal(
            want[start:stop], ts1._a_column(small, seed, start, stop, 2, "cpu").numpy())
