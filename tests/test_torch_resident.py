"""The one-launch rotation (ops/fused.blind_rotate_fused, the counterpart of
the JAX package's resident kernel `_rotate_kernel`) on the CPU: its plain
version against the JAX package's rotation bit for bit at Params(64) on the
JAX package's key (exact, pruned and randomized modes, one case against the
Pallas kernel in interpret mode, a ragged last tile), and its launch plan
`resident_plan` over every shape a resident-size key can have.
tests/test_torch_kernels.py holds the CUDA kernel against this plain
version on a card. Last, the gate path through that route: `bootstrap_batch`
on 8 gates with `_rotation_route` made to answer "resident" runs the plain
version on the CPU, gives the `plain` route's answers bit for bit, and
decrypts to AND, OR and XOR by the benchmark's numpy reference
(fhebench/reference/)."""

import itertools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# The twins issue many small ops: one thread each, or the parallel test
# workers oversubscribe the cores and run many times slower.
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from fhebench.reference import lwe, plain  # noqa: E402
import sgfhe_tpu as F  # noqa: E402
from sgfhe_tpu.models import bootstrap as rbs  # noqa: E402
from sgfhe_tpu.ops import rns as rrns  # noqa: E402

import sgfhe_tpu_torch as T  # noqa: E402
from sgfhe_tpu_torch import interop  # noqa: E402
from sgfhe_tpu_torch.models import bootstrap as tbs  # noqa: E402
from sgfhe_tpu_torch.ops import fused as tfused  # noqa: E402

SEED_KEY = 13  # the randomized mode's jax.random key


@pytest.fixture(scope="module")
def ref():
    """Params(64) with the JAX package's key (made as
    tests/test_torch_bootstrap.py makes it), carried over to the port, and
    five gates of random canonical accumulators and exponents."""
    params = F.Params.create(64)
    ctx = F.make_context(params)
    k_sk, k_bk = jax.random.split(jax.random.key(77))
    sk = F.PrivateKey.create(params, k_sk)
    bkey = F.BootstrapKey.create(ctx, sk, k_bk)
    tbk = interop.bootstrap_key(params, np.asarray(bkey.hat), np.asarray(bkey.hat_shoup), "cpu")
    rng = np.random.default_rng(77)
    B, L, m = 5, params.num_limbs, params.m
    p = np.array(params.moduli).reshape(L, 1)
    ua = rng.integers(0, 2 * m, (B, params.n))
    a0 = rng.integers(0, 1 << 30, (B, L, m)) % p
    b0 = rng.integers(0, 1 << 30, (B, L, m)) % p
    return dict(params=params, ctx=ctx, bkey=bkey, tctx=T.make_context(params, device="cpu"),
                tbk=tbk, ua=ua, a0=a0, b0=b0, secret=np.asarray(sk.key).astype(np.int64))


def _reference(s, B, prune, randomized, fused):
    """The JAX package's blind_rotate (what its bootstrap_internal runs) on
    the first B gates: the jnp path, or fused=("resident", True), the Pallas
    kernel in interpret mode."""
    key = jax.random.key(SEED_KEY) if randomized else None
    ua, a0, b0 = (jnp.asarray(s[k][:B], jnp.uint32) for k in ("ua", "a0", "b0"))
    out = rbs.blind_rotate(s["params"], s["ctx"], s["bkey"].hat, s["bkey"].hat_shoup, ua, a0,
                           b0, key, fused, prune)
    return tuple(np.asarray(x).astype(np.int64) for x in out)


def _port(s, B, prune, randomized, gates=None):
    seed2 = tuple(int(w) for w in rrns.seed_words(jax.random.key(SEED_KEY))) if randomized else None
    ua, a0, b0 = (torch.as_tensor(s[k][:B]) for k in ("ua", "a0", "b0"))
    out = tfused.blind_rotate_fused_plain(s["tctx"], s["tbk"].hat, ua, a0, b0, seed2, prune,
                                          gates)
    return tuple(x.numpy() for x in out)


@pytest.fixture(scope="module")
def randomized5(ref):
    """The JAX package's randomized rotation of all five gates: its first
    four are the B = 4 case (a gate's masks follow its index alone), all
    five the ragged-tile case."""
    return _reference(ref, 5, 0, True, ("none", False))


@pytest.mark.parametrize(
    "prune,fused",
    [(0, ("none", False)), (1, ("none", False)), (2, ("resident", True))],
    ids=["exact", "prune1", "prune2-pallas-interpret"],
)
def test_plain_equals_reference(ref, prune, fused):
    want = _reference(ref, 4, prune, False, fused)
    for w, g in zip(want, _port(ref, 4, prune, False)):
        np.testing.assert_array_equal(w, g)


def test_plain_randomized_equals_reference(ref, randomized5):
    for w, g in zip(randomized5, _port(ref, 4, 0, True)):
        np.testing.assert_array_equal(w[:4], g)


def test_plain_ragged_tile_equals_reference(ref, randomized5):
    """B = 5 in tiles of G = 2: the last tile holds one gate, whose masks
    take its global index."""
    assert tfused.resident_plan(5, 3, 3, 512, 0, gates=2).grid == 3
    for w, g in zip(randomized5, _port(ref, 5, 0, True, gates=2)):
        np.testing.assert_array_equal(w, g)


def test_wrapper_on_cpu_takes_plain_version(ref):
    """blind_rotate_fused on CPU tensors runs the plain version on the
    plan's tiles and launches nothing."""
    before = tfused.blind_rotate_fused.launches
    ua, a0, b0 = (torch.as_tensor(ref[k][:1]) for k in ("ua", "a0", "b0"))
    got = tfused.blind_rotate_fused(ref["tctx"], ref["tbk"].hat, ua, a0, b0, prune=2)
    want = tfused.blind_rotate_fused_plain(ref["tctx"], ref["tbk"].hat, ua, a0, b0, prune=2)
    assert all(torch.equal(w, g) for w, g in zip(want, got))
    assert tfused.blind_rotate_fused.launches == before


# every shape of a resident-size key: n >= 64 steps (both schemes), l = L
RESIDENT_SHAPES = [
    (n, L, m)
    for n, L, m in itertools.product((64, 128, 256), (2, 3, 4), (512, 1024, 2048, 4096))
    if 32 * n * L * L * m <= tbs._RESIDENT_KEY_BYTES
]
BATCHES = (1, 2, 5, 31, 32, 131, 132, 133, 257, 1000, 4096, 8192)


def test_resident_shapes_are_known():
    """At most L = 3 limbs and m = 1024: within the kernel's shapes."""
    assert {(L, m) for _, L, m in RESIDENT_SHAPES} == {(2, 512), (2, 1024), (3, 512)}


@pytest.mark.parametrize(
    "n,L,m,prune", [(n, L, m, prune) for n, L, m in RESIDENT_SHAPES for prune in range(L)])
def test_resident_plan_fits_and_covers(n, L, m, prune):
    for B in BATCHES:
        pl = tfused.resident_plan(B, L, L, m, prune)
        assert pl.smem == pl.gates * tfused.resident_gate_bytes(L, m, prune)
        assert pl.smem <= tfused.SMEM_BLOCK
        assert pl.threads % 32 == 0 and 32 <= pl.threads <= tfused.RES_MAX_THREADS
        assert pl.per_sm >= 1 and pl.threads * pl.per_sm <= 1024
        # every gate in exactly one tile
        tiles = [range(t * pl.gates, min(B, (t + 1) * pl.gates)) for t in range(pl.grid)]
        assert sorted(g for t in tiles for g in t) == list(range(B))
        assert all(len(t) for t in tiles)


def test_resident_plan_small_and_full_batches():
    """One gate a block where the grid cannot fill the card; several at
    Params(64)'s 4096 gates."""
    assert tfused.resident_plan(32, 3, 3, 512, 0).gates == 1
    full = tfused.resident_plan(4096, 3, 3, 512, 0)
    assert full.gates > 1 and full.grid * full.gates >= 4096


def test_route_matches_resident_plan():
    """Every parameter set the route sends to rotate_resident has a plan,
    in every mode; the others take the step pair."""
    cuda = torch.device("cuda")
    sets = [T.Params.create(n) for n in (64, 128)] + [
        T.Scheme2.Params.create(k, 64) for k in (1, 2)]
    for params in sets:
        resident = tbs._rotation_route(params, cuda) == "resident"
        assert resident == (tfused.fused_bkey_bytes(params) <= tbs._RESIDENT_KEY_BYTES)
        if resident:
            for prune in range(params.num_limbs):
                tfused.resident_plan(4096, params.num_limbs, params.num_digits, params.m,
                                     prune)


@pytest.mark.parametrize("L,m,prune", [(4, 2048, 0), (3, 4096, 0), (4, 8192, 3)])
def test_wrapper_refuses_shape_beyond_shared_memory(ref, L, m, prune):
    a0 = torch.zeros((1, L, m), dtype=torch.int64)
    key = torch.zeros((1, 2 * L, 2, L, m), dtype=torch.int32)
    ua = torch.zeros((1, 1), dtype=torch.int64)
    with pytest.raises(ValueError, match="232,448 bytes"):
        tfused.blind_rotate_fused(ref["tctx"], key, ua, a0, a0, prune=prune)


GATES = 8


@pytest.fixture(scope="module")
def gates(ref):
    """8 gate pairs under the carried-over key, and the answers of one
    `bootstrap_batch` call by each route: `plain`, and `resident` with the
    plain version's calls counted."""
    g = torch.Generator().manual_seed(64)
    params = T.Params.create(64)
    sk = T.PrivateKey(params, torch.as_tensor(ref["secret"]))
    msg = torch.randint(0, 2, (params.n,), generator=g)
    bits = T.split_ciphertext(T.encrypt(sk, g, msg)).lwe
    ins = [T.LWE(bits.a[i:2 * GATES:2], bits.b[i:2 * GATES:2]) for i in (0, 1)]

    def call():
        return tbs.bootstrap_batch(params, ref["tctx"], ref["tbk"].hat, ref["tbk"].hat_shoup,
                                   *ins)

    want = call()
    mp = pytest.MonkeyPatch()
    tiles = []
    fused_plain = tfused.blind_rotate_fused_plain

    def counted(*args, **kwargs):
        tiles.append(args[2].shape[0])
        return fused_plain(*args, **kwargs)

    mp.setattr(tbs, "_rotation_route", lambda params, device: "resident")
    mp.setattr(tfused, "blind_rotate_fused_plain", counted)
    launches = tfused.blind_rotate_fused.launches
    try:
        got = call()
    finally:
        mp.undo()
    return dict(params=params, msg=msg[:2 * GATES].numpy(), want=want, got=got, tiles=tiles,
                launched=tfused.blind_rotate_fused.launches - launches)


def test_resident_route_runs_the_plain_version(gates):
    """blind_rotate_fused takes its plain version on the CPU, once, on all
    8 gates, and launches nothing."""
    assert gates["tiles"] == [GATES]
    assert gates["launched"] == 0


@pytest.mark.parametrize("gate", range(3), ids=["and", "or", "xor"])
def test_resident_route_equals_plain_route(gates, gate):
    for w, g in zip((gates["want"][gate].a, gates["want"][gate].b),
                    (gates["got"][gate].a, gates["got"][gate].b)):
        assert torch.equal(w, g)


def test_answers_decrypt_to_the_gates_by_the_reference(ref, gates):
    p, msg = gates["params"], gates["msg"]
    for out, expected in zip(gates["got"], plain.gates(msg[0::2], msg[1::2])):
        answers, wrong, _ = lwe.judge(out.a.numpy(), out.b.numpy(), ref["secret"], p.r, p.Dr,
                                      expected)
        assert (answers, wrong) == (GATES, 0)
