"""The port's wire frames and npz checkpoints (sgfhe_tpu_torch/serialize.py)
against the JAX package's (sgfhe_tpu/serialize.py) on the CPU: every frame
type byte for byte from the same arrays and loadable both ways, faults
refused, checkpoints both ways, and the slice as a whole:
reference keys and ciphertexts through frames into the port's gate
bootstrap, and its outputs back through frames into the reference, bit for
bit against the reference's own bootstrap. The seeded bootstrap keys are
tests/test_torch_seeded_keys.py."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# The twins issue many small ops: one thread each, or the parallel test
# workers oversubscribe the cores and run many times slower.
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import sgfhe_tpu as F  # noqa: E402
from sgfhe_tpu import serialize as RS  # noqa: E402
from sgfhe_tpu.models import scheme2 as rs2  # noqa: E402

import sgfhe_tpu_torch as T  # noqa: E402
from sgfhe_tpu_torch import interop  # noqa: E402
from sgfhe_tpu_torch import serialize as TS  # noqa: E402
from sgfhe_tpu_torch.models import scheme2 as ts2  # noqa: E402


def _eq(ref, got):
    np.testing.assert_array_equal(np.asarray(ref), interop.to_numpy(got))


def _j(x):
    return jnp.asarray(np.asarray(x, dtype=np.uint32))


@pytest.fixture(scope="module")
def ref64():
    """Reference keys at Params(64); the bootstrap key from jax.random.key(5)."""
    params = F.Params.create(64)
    ctx = F.make_context(params)
    sk = F.PrivateKey.create(params, jax.random.key(1))
    bkey = F.BootstrapKey.create(ctx, sk, jax.random.key(5))
    return dict(params=params, ctx=ctx, sk=sk, bkey=bkey,
                tctx=T.make_context(params, device="cpu"))


@pytest.fixture(scope="module")
def toy2():
    """Scheme 2 at k = 1, n = 64: reference keys and the port's context."""
    params = rs2.Params.create(1, n=64)
    ctx = rs2.make_context(params)
    sk = rs2.PrivateKey.create(params, jax.random.key(2))
    tp = interop.scheme2_params(params)
    return dict(params=params, ctx=ctx, sk=sk, bkey=rs2.BootstrapKey.create(ctx, sk,
                                                                           jax.random.key(7)),
                tp=tp, tctx=ts2.make_context(tp, device="cpu"))


# ---------------------------------------------------------------------------
# Every frame type, byte for byte, from the same arrays
# ---------------------------------------------------------------------------


def _frame_cases(params, p2):
    """(name, reference frame, port frame, arrays to compare after a load as
    (ref getter, port getter) pairs), objects made from the same random
    arrays of the right ranges."""
    rng = np.random.default_rng(64)
    n, m, L, l, r = params.n, params.m, params.num_limbs, params.num_digits, params.r
    q = params.q_factors[0]
    mods = np.array(params.moduli, dtype=np.int64).reshape(L, 1)
    key = rng.integers(0, 2, n)
    k0, k1 = rng.integers(0, q, n), rng.integers(0, q, n)
    hat = rng.integers(0, 1 << 30, (n, 2 * l, 2, L, m)) % mods
    shoup = (hat << 32) // mods
    ct_a, ct_b = rng.integers(0, r, n), rng.integers(0, r, n)
    cm_a, cm_b = rng.integers(0, r, m), rng.integers(0, r, m)
    eb_a, eb_b = rng.integers(0, r, (3, 5, n)), rng.integers(0, r, (3, 5))
    u, v = rng.integers(0, 2, n), rng.integers(0, 2, (5, n))
    pa, pb = rng.integers(0, 2, (params.t + 1, n)), rng.integers(0, 2, (6, n))
    s2_a, s2_b = rng.integers(0, p2.r, p2.n), rng.integers(0, p2.r, p2.n)
    s2la, s2lb = rng.integers(0, p2.r, (7, p2.n)), rng.integers(0, p2.r, 7)
    u8 = lambda x: torch.as_tensor(x).to(torch.uint8)  # noqa: E731
    tp2 = interop.scheme2_params(p2)
    return [
        ("private key", RS.to_wire(F.PrivateKey(params, _j(key))),
         TS.to_wire(interop.private_key(params, key, "cpu")),
         [(lambda o: o.key, lambda o: o.key)]),
        ("public key", RS.to_wire(F.PublicKey(params, _j(k0), _j(k1))),
         TS.to_wire(interop.public_key(params, k0, k1, "cpu")),
         [(lambda o: o.k0, lambda o: o.k0), (lambda o: o.k1, lambda o: o.k1)]),
        ("bootstrap key", RS.to_wire(F.BootstrapKey(params, _j(hat), _j(shoup))),
         TS.to_wire(interop.bootstrap_key(params, hat, shoup, "cpu")),
         [(lambda o: o.hat, lambda o: o.hat), (lambda o: o.hat_shoup, lambda o: o.hat_shoup)]),
        ("packed ciphertext", RS.to_wire(F.PackedCiphertext(params, F.RLWE(_j(ct_a), _j(ct_b)))),
         TS.to_wire(interop.packed_ciphertext(params, ct_a, ct_b, "cpu")),
         [(lambda o: o.rlwe.a, lambda o: o.rlwe.a), (lambda o: o.rlwe.b, lambda o: o.rlwe.b)]),
        ("ciphertext", RS.to_wire(F.Ciphertext(params, F.RLWE(_j(cm_a), _j(cm_b)))),
         TS.to_wire(interop.ciphertext(params, cm_a, cm_b, "cpu")),
         [(lambda o: o.rlwe.a, lambda o: o.rlwe.a), (lambda o: o.rlwe.b, lambda o: o.rlwe.b)]),
        ("encrypted bits", RS.to_wire(F.EncryptedBit(F.LWE(_j(eb_a), _j(eb_b)))),
         TS.to_wire(T.EncryptedBit(interop.lwe(eb_a, eb_b, "cpu"))),
         [(lambda o: o.lwe.a, lambda o: o.lwe.a), (lambda o: o.lwe.b, lambda o: o.lwe.b)]),
        ("one encrypted bit", RS.to_wire(F.EncryptedBit(F.LWE(_j(eb_a[1, 2]), _j(eb_b[1, 2])))),
         TS.to_wire(T.EncryptedBit(interop.lwe(eb_a[1, 2], eb_b[1, 2], "cpu"))),
         [(lambda o: o.lwe.a, lambda o: o.lwe.a), (lambda o: o.lwe.b, lambda o: o.lwe.b)]),
        ("private space-optimal",
         RS.to_wire(F.PrivateEncryptedCiphertext(params, _j(u).astype(jnp.uint8),
                                                 _j(v).astype(jnp.uint8))),
         TS.to_wire(T.PrivateEncryptedCiphertext(params, u8(u), u8(v))),
         [(lambda o: o.u, lambda o: o.u), (lambda o: o.v, lambda o: o.v)]),
        ("public space-optimal",
         RS.to_wire(F.PublicEncryptedCiphertext(params, _j(pa).astype(jnp.uint8),
                                                _j(pb).astype(jnp.uint8))),
         TS.to_wire(T.PublicEncryptedCiphertext(params, u8(pa), u8(pb))),
         [(lambda o: o.a_bits, lambda o: o.a_bits), (lambda o: o.b_bits, lambda o: o.b_bits)]),
        ("scheme-2 ciphertext", RS.s2_ciphertext_to_wire(p2, _j(s2_a), _j(s2_b)),
         TS.s2_ciphertext_to_wire(tp2, interop.tensor(s2_a, "cpu"), interop.tensor(s2_b, "cpu")),
         [(lambda o: o[1], lambda o: o[1]), (lambda o: o[2], lambda o: o[2])]),
        ("scheme-2 LWE", RS.s2_lwe_to_wire(p2, F.LWE(_j(s2la), _j(s2lb))),
         TS.s2_lwe_to_wire(tp2, interop.lwe(s2la, s2lb, "cpu")),
         [(lambda o: o[1].a, lambda o: o[1].a), (lambda o: o[1].b, lambda o: o[1].b)]),
    ]


def test_every_frame_type_byte_identical_and_loads_both_ways(ref64, toy2):
    cases = _frame_cases(ref64["params"], toy2["params"])
    assert {c[1][5] for c in cases} == set(range(1, 11))
    for name, ref_raw, port_raw, fields in cases:
        assert ref_raw == port_raw, f"{name}: frames differ"
        from_ref = TS.from_wire(ref_raw, device="cpu")
        from_port = RS.from_wire(port_raw)
        for get_ref, get_port in fields:
            _eq(get_ref(from_port), get_port(from_ref))
        if not name.startswith("scheme-2"):
            assert TS.to_wire(from_ref) == ref_raw, f"{name}: port's frame of its load differs"
    # the loaded scheme-2 params are the port's
    p2, _, _ = TS.from_wire(cases[-2][2], device="cpu")
    assert p2 == toy2["tp"]


def test_objects_on_requested_device(ref64):
    params = ref64["params"]
    raw = TS.to_wire(interop.private_key(params, np.ones(params.n, dtype=np.uint32), "cpu"))
    assert TS.from_wire(raw, device="cpu").key.device.type == "cpu"
    assert TS.from_wire(raw, ref64["tctx"]).key.device == ref64["tctx"].device


# ---------------------------------------------------------------------------
# Faults
# ---------------------------------------------------------------------------


def test_faults_raise(ref64, toy2):
    for bkey in (ref64["bkey"], toy2["bkey"]):
        _, meta, payload = TS._unframe(RS.bootstrap_key_to_wire_seeded(bkey))
        for stream in (meta["stream"] + 1, 3 - meta["stream"]):
            bad = TS._frame(TS._T_BKEY_SEEDED, dict(meta, stream=stream), [payload])
            with pytest.raises(ValueError, match="stream"):
                TS.from_wire(bad, device="cpu")
        bad = TS._frame(TS._T_BKEY_SEEDED, dict(meta, seedwords=3), [payload])
        with pytest.raises(ValueError, match="seed words"):
            TS.from_wire(bad, device="cpu")
    raw = TS.to_wire(interop.private_key(ref64["params"], np.ones(64, dtype=np.uint32), "cpu"))
    flipped = bytearray(raw)
    flipped[len(raw) // 2] ^= 0x40
    with pytest.raises(ValueError, match="CRC"):
        TS.from_wire(bytes(flipped), device="cpu")
    for short in (raw[:10], raw[:-1]):
        with pytest.raises(ValueError):
            TS.from_wire(short, device="cpu")
    # a payload shorter than its length field, with a valid CRC
    _, meta, payload = TS._unframe(raw)
    cut = TS._frame(TS._T_PRIVATE_KEY, meta, [payload[:4]])
    with pytest.raises(ValueError, match="truncated"):
        TS.from_wire(cut, device="cpu")
    with pytest.raises(ValueError, match="magic"):
        TS.from_wire(b"XXXX" + raw[4:], device="cpu")
    with pytest.raises(TypeError):
        TS.to_wire(object())
    with pytest.raises(ValueError, match="no seed"):
        TS.bootstrap_key_to_wire_seeded(T.BootstrapKey(ref64["params"], None, None))


# ---------------------------------------------------------------------------
# npz checkpoints
# ---------------------------------------------------------------------------


def test_checkpoints_both_ways(tmp_path, ref64, toy2):
    fields = {"PrivateKey": ("key",), "PublicKey": ("k0", "k1"),
              "BootstrapKey": ("hat", "hat_shoup")}
    pk = F.PublicKey.create(ref64["ctx"], ref64["sk"], jax.random.key(3))
    pk2 = rs2.PublicKey.create(toy2["ctx"], toy2["sk"], jax.random.key(4))
    objs = [ref64["sk"], pk, ref64["bkey"], toy2["sk"], pk2, toy2["bkey"]]
    for i, obj in enumerate(objs):
        name = type(obj).__name__
        RS.save(str(tmp_path / f"ref{i}.npz"), obj)
        got = TS.load(str(tmp_path / f"ref{i}.npz"), device="cpu")
        assert type(got).__name__ == name and repr(got.params) == repr(obj.params)
        for f in fields[name]:
            _eq(getattr(obj, f), getattr(got, f))
        TS.save(str(tmp_path / f"port{i}.npz"), got)
        back = RS.load(str(tmp_path / f"port{i}.npz"))
        assert type(back) is type(obj)
        for f in fields[name]:
            np.testing.assert_array_equal(np.asarray(getattr(obj, f)),
                                          np.asarray(getattr(back, f)))
    assert isinstance(TS.load(str(tmp_path / "ref5.npz"), device="cpu"), ts2.BootstrapKey)


# ---------------------------------------------------------------------------
# The slice as a whole
# ---------------------------------------------------------------------------


def test_reference_frames_through_port_bootstrap(ref64):
    """Reference keys and ciphertexts -> frames -> the port's plain
    bootstrap_batch on 16 gates -> EncryptedBit frames -> the reference:
    equal bit for bit to the reference's own bootstrap_batch."""
    params, ctx, sk, bkey = ref64["params"], ref64["ctx"], ref64["sk"], ref64["bkey"]
    k_m, k_e = jax.random.split(jax.random.key(21))
    msg = jax.random.bernoulli(k_m, 0.5, (params.n,))
    bits = F.split_ciphertext(F.encrypt(sk, k_e, msg))
    B = 16
    l1 = F.LWE(bits.lwe.a[0:2 * B:2], bits.lwe.b[0:2 * B:2])
    l2 = F.LWE(bits.lwe.a[1:2 * B:2], bits.lwe.b[1:2 * B:2])
    want = F.bootstrap_batch(params, ctx, bkey.hat, bkey.hat_shoup, l1, l2)

    tctx = ref64["tctx"]
    tbk = TS.from_wire(RS.bootstrap_key_to_wire_seeded(bkey), tctx)
    tsk = TS.from_wire(RS.to_wire(sk), tctx)
    e1 = TS.from_wire(RS.to_wire(F.EncryptedBit(l1)), tctx)
    e2 = TS.from_wire(RS.to_wire(F.EncryptedBit(l2)), tctx)
    out = T.bootstrap_batch(params, tctx, tbk.hat, tbk.hat_shoup, e1.lwe, e2.lwe)
    y1, y2 = np.asarray(msg)[0:2 * B:2], np.asarray(msg)[1:2 * B:2]
    for lwe, ref_lwe, truth in zip(out, want, (y1 & y2, y1 | y2, y1 ^ y2)):
        back = RS.from_wire(TS.to_wire(T.EncryptedBit(lwe)))
        np.testing.assert_array_equal(np.asarray(back.lwe.a), np.asarray(ref_lwe.a))
        np.testing.assert_array_equal(np.asarray(back.lwe.b), np.asarray(ref_lwe.b))
        np.testing.assert_array_equal(np.asarray(F.decrypt_bit(sk, back)), truth)
        np.testing.assert_array_equal(T.decrypt_bit(tsk, T.EncryptedBit(lwe)).numpy(), truth)
