"""Shared set-up of the scheme-2 parity files at k = 3, 4 and 5
(tests/test_torch_scheme2_k35.py, _k4.py, _k5.py): the JAX package's keys
at n = 64, the port's copies of them, two encrypted digit pairs, and one
add_with_carry through both packages, compared bit for bit."""

import numpy as np

import jax
import jax.numpy as jnp

from sgfhe_tpu.models import bootstrap2 as rb2
from sgfhe_tpu.models import scheme2 as rs2
from sgfhe_tpu.models.scheme1 import LWE as RLWE1
from sgfhe_tpu.ops import rns as rrns

from sgfhe_tpu_torch import interop
from sgfhe_tpu_torch.models import bootstrap2 as tb2
from sgfhe_tpu_torch.models import scheme2 as ts2

PAIRS = 2
FLAT_KEY, EPOCH = 82, 7  # the randomized mode's key and pinned epoch


def setup(k: int, seed: int) -> dict:
    """Scheme 2 at k, n = 64 in both packages, on the JAX package's keys,
    and PAIRS digit pairs (x, y) encrypted by it."""
    params = rs2.Params.create(k, n=64)
    ctx = rs2.make_context(params)
    sk = rs2.PrivateKey.create(params, jax.random.key(seed))
    bkey = rs2.BootstrapKey.create(ctx, sk, jax.random.key(seed + 1))
    tp = interop.scheme2_params(params)
    s = dict(params=params, ctx=ctx, sk=sk, bkey=bkey, tp=tp,
             tctx=ts2.make_context(tp, device="cpu"),
             tsk=interop.private_key(tp, np.asarray(sk.key), "cpu"),
             tbk=interop.bootstrap_key(tp, np.asarray(bkey.hat), np.asarray(bkey.hat_shoup),
                                       "cpu"))
    rng = np.random.default_rng(k)
    for name, key in (("x", 50), ("y", 51)):
        vals = rng.integers(0, 2**k, PAIRS)
        msg = np.zeros(params.n, dtype=np.int64)
        msg[:PAIRS] = vals
        a, b = rs2.encrypt(sk, jax.random.key(seed + key), jnp.asarray(msg))
        lwe = rb2.split_ciphertext(params, a, b)
        s[name] = vals
        s["r" + name] = RLWE1(lwe.a[:PAIRS], lwe.b[:PAIRS])
        s["t" + name] = interop.lwe(np.asarray(lwe.a[:PAIRS]), np.asarray(lwe.b[:PAIRS]), "cpu")
    return s


def seed_words(key, epoch) -> tuple:
    """The folded seed words the JAX package's rotation draws its masks from."""
    return tuple(int(w) for w in rrns.seed_words(jax.random.fold_in(key, epoch)))


def check_add_with_carry(s: dict, mode: str) -> None:
    """add_with_carry in `mode` ("exact", "prune=N" or "randomized") through
    both packages: equal bit for bit, and every digit and carry right."""
    prune = int(mode.split("=")[1]) if mode.startswith("prune=") else 0
    fk = jax.random.key(FLAT_KEY) if mode == "randomized" else None
    ref = rb2.add_with_carry(s["params"], s["ctx"], s["bkey"], s["rx"], s["ry"],
                             flat_key=fk, epoch=EPOCH, prune=prune)
    seed2 = seed_words(fk, EPOCH) if fk is not None else None
    got = tb2._add_with_carry(s["tp"], s["tctx"], s["tbk"], s["tx"], s["ty"], None, seed2,
                              prune)
    for r, g in zip(ref, got):
        np.testing.assert_array_equal(np.asarray(r.a), interop.to_numpy(g.a))
        np.testing.assert_array_equal(np.asarray(r.b), interop.to_numpy(g.b))
    z = s["x"] + s["y"]
    K = 2**s["tp"].k
    np.testing.assert_array_equal(tb2.decrypt_lwe(s["tsk"], got[0]).numpy(), z % K)
    np.testing.assert_array_equal(tb2.decrypt_lwe(s["tsk"], got[1]).numpy(), z // K)
