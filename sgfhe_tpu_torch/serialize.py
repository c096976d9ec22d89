"""Wire frames and npz checkpoints of keys and ciphertexts (counterpart of
sgfhe_tpu/serialize.py, byte for byte: a frame or checkpoint written by
either package loads in the other).

Frame: b"SGFW" | version u8 | type u8 | meta_len u16le | meta json (sorted
keys) | payload_len u64le | payload | crc32 u32le over all preceding bytes.
Numeric payloads use the dense width-packed codec (native.py): log2(r) bits
a coefficient of a ciphertext mod r, max(log2 p_i) bits a residue of the
bootstrap key, whose Shoup companions are recomputed on load. The seeded
bootstrap-key frame carries the a-column's seed and the b-column only; its
meta's `stream` names the draw that rebuilds the a-column (1: scheme 1's
one-shot draw, 2: scheme 2's chunked draw; models/scheme1._a_column), and a
frame of another stream raises instead of loading a mismatched key.

Objects come back on `ctx.device`, else on `device`, else on the card
(scheme1.resolve_device). A frame is assembled in one pass: its parts are
packed once, the CRC chained over them, and one join copies them.
"""

from __future__ import annotations

import json

import numpy as np
import torch

from . import interop
from . import native
from .models import scheme1 as s1
from .models import scheme2 as s2
from .models.params import Params
from .ops import modmath as mm

MAGIC = "sgfhe_tpu/v1"

_WIRE_MAGIC = b"SGFW"
_WIRE_VERSION = 1

_T_PRIVATE_KEY = 1
_T_PUBLIC_KEY = 2
_T_BOOTSTRAP_KEY = 3
_T_PACKED_CT = 4
_T_CIPHERTEXT = 5
_T_ENCRYPTED_BIT = 6
_T_PRIVATE_CT = 7
_T_PUBLIC_CT = 8
_T_S2_CIPHERTEXT = 9   # scheme-2 (a, b) digit-polynomial pair mod r
_T_S2_LWE = 10         # scheme-2 digit LWE batch
_T_BKEY_SEEDED = 11    # bootstrap key as (seed, b-column), both schemes

#: The a-column stream each scheme's seeded frame is written and read with.
_SEED_STREAM = {1: 1, 2: 2}

# magic(4) + version(1) + type(1) + meta_len(2) + payload_len(8) + crc(4)
_MIN_FRAME = 4 + 1 + 1 + 2 + 8 + 4


def _u8(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy().astype(np.uint8)


# -- space-optimal ciphertext byte encodings ----------------------------------


def private_ciphertext_to_bytes(ct: s1.PrivateEncryptedCiphertext) -> bytes:
    """6n bits -> ceil(6n/8) bytes: u, then v row by row."""
    return native.packbits(np.concatenate([_u8(ct.u).reshape(-1), _u8(ct.v).reshape(-1)])).tobytes()


def private_ciphertext_from_bytes(params: Params, raw, device=None):
    n = params.n
    dev = s1.resolve_device(device)
    bits = torch.from_numpy(native.unpackbits(raw, 6 * n)).to(dev)
    return s1.PrivateEncryptedCiphertext(params, bits[:n], bits[n:].reshape(5, n))


def public_ciphertext_to_bytes(ct: s1.PublicEncryptedCiphertext) -> bytes:
    return native.packbits(np.concatenate([_u8(ct.a_bits).reshape(-1),
                                           _u8(ct.b_bits).reshape(-1)])).tobytes()


def public_ciphertext_from_bytes(params: Params, raw, device=None):
    n, rows = params.n, params.t + 1
    dev = s1.resolve_device(device)
    bits = torch.from_numpy(native.unpackbits(raw, (rows + 6) * n)).to(dev)
    return s1.PublicEncryptedCiphertext(params, bits[:rows * n].reshape(rows, n),
                                        bits[rows * n:].reshape(6, n))


# -- framed wire format --------------------------------------------------------


def _frame(type_code: int, meta: dict, parts) -> bytes:
    mb = json.dumps(meta, sort_keys=True).encode()
    size = sum(memoryview(p).nbytes for p in parts)
    head = (_WIRE_MAGIC + bytes([_WIRE_VERSION, type_code]) + len(mb).to_bytes(2, "little")
            + mb + size.to_bytes(8, "little"))
    crc = native.crc32(head)
    for p in parts:
        crc = native.crc32(p, crc)
    return b"".join([head, *parts, crc.to_bytes(4, "little")])


def _unframe(raw) -> tuple[int, dict, memoryview]:
    view = memoryview(raw).cast("B")
    if len(view) < _MIN_FRAME:
        raise ValueError(f"wire frame too short: {len(view)} bytes < the {_MIN_FRAME}-byte "
                         f"header+CRC minimum")
    if view[:4] != _WIRE_MAGIC:
        raise ValueError("not an sgfhe wire frame (bad magic)")
    if view[4] != _WIRE_VERSION:
        raise ValueError(f"unsupported wire version {view[4]}")
    crc_stored = int.from_bytes(view[-4:], "little")
    crc = native.crc32(view[:-4])
    if crc != crc_stored:
        raise ValueError(f"wire CRC mismatch: stored {crc_stored:#010x}, computed {crc:#010x}")
    meta_len = int.from_bytes(view[6:8], "little")
    off = 8 + meta_len
    if off + 8 > len(view) - 4:
        raise ValueError("truncated wire frame")
    meta = json.loads(bytes(view[8:off]).decode())
    payload_len = int.from_bytes(view[off:off + 8], "little")
    payload = view[off + 8:off + 8 + payload_len]
    if len(payload) != payload_len:
        raise ValueError("truncated wire frame")
    return view[5], meta, payload


def _packed(width: int, *tensors) -> list:
    """Each tensor's uint32 values packed at `width` bits: payload parts."""
    return [native.pack_uint(interop.to_numpy(t), width) for t in tensors]


def _r_bits(params) -> int:
    return params.r.bit_length() - 1  # r is a power of two


def _key_bits(params) -> int:
    return max(q.bit_length() for q in params.moduli)


class _Reader:
    """Consecutive width-packed fields of a payload."""

    def __init__(self, payload):
        self.payload, self.pos = payload, 0

    def uint(self, count: int, width: int) -> np.ndarray:
        n_bytes = (count * width + 7) // 8
        out = native.unpack_uint(self.payload[self.pos:self.pos + n_bytes], count, width)
        self.pos += n_bytes
        return out


def _lwe_parts(a: torch.Tensor, b: torch.Tensor, width: int, what: str):
    """Payload parts and batch shape of an LWE batch: a (..., n), b (...)."""
    bshape = list(a.shape[:-1])
    if list(b.shape) != bshape:
        raise ValueError(f"{what} a/b batch shapes disagree: {tuple(a.shape[:-1])} vs "
                         f"{tuple(b.shape)}")
    return _packed(width, a, b), bshape


def _lwe_from(payload, n: int, bshape: tuple, width: int, dev) -> s1.LWE:
    rows = int(np.prod(bshape, dtype=np.int64)) if bshape else 1
    rd = _Reader(payload)
    a, b = rd.uint(rows * n, width), rd.uint(rows, width)
    if not bshape:
        return s1.LWE(interop.tensor(a, dev), interop.tensor(b[0], dev))
    return s1.LWE(interop.tensor(a.reshape(bshape + (n,)), dev),
                  interop.tensor(b.reshape(bshape), dev))


def to_wire(obj) -> bytes:
    """Serialize a scheme-1 object to a self-describing CRC-checked frame."""
    if isinstance(obj, s1.PrivateKey):
        return _frame(_T_PRIVATE_KEY, {"n": obj.params.n}, [native.packbits(_u8(obj.key))])
    if isinstance(obj, s1.PublicKey):
        p = obj.params
        # RNS-q keys store (Lq, n) residue stacks; the width covers the
        # largest factor
        w = max(q.bit_length() for q in p.q_factors)
        return _frame(_T_PUBLIC_KEY, {"n": p.n}, _packed(w, obj.k0, obj.k1))
    if isinstance(obj, s1.BootstrapKey):
        return _frame(_T_BOOTSTRAP_KEY, {"n": obj.params.n},
                      _packed(_key_bits(obj.params), obj.hat))
    if isinstance(obj, (s1.PackedCiphertext, s1.Ciphertext)):
        p = obj.params
        code = _T_PACKED_CT if isinstance(obj, s1.PackedCiphertext) else _T_CIPHERTEXT
        return _frame(code, {"n": p.n}, _packed(_r_bits(p), obj.rlwe.a, obj.rlwe.b))
    if isinstance(obj, s1.EncryptedBit):
        n = obj.lwe.a.shape[-1]
        # r = 16n fixes the width; the full batch shape rides the meta
        parts, bshape = _lwe_parts(obj.lwe.a, obj.lwe.b, (16 * n).bit_length() - 1,
                                   "EncryptedBit")
        return _frame(_T_ENCRYPTED_BIT, {"n": n, "shape": bshape}, parts)
    if isinstance(obj, s1.PrivateEncryptedCiphertext):
        return _frame(_T_PRIVATE_CT, {"n": obj.params.n}, [private_ciphertext_to_bytes(obj)])
    if isinstance(obj, s1.PublicEncryptedCiphertext):
        return _frame(_T_PUBLIC_CT, {"n": obj.params.n}, [public_ciphertext_to_bytes(obj)])
    raise TypeError(f"no wire format for {type(obj)}")


def s2_ciphertext_to_wire(params: s2.Params, a: torch.Tensor, b: torch.Tensor) -> bytes:
    """Scheme-2 digit-polynomial ciphertext (scheme2.encrypt's (a, b)):
    log2(r) bits a coefficient."""
    return _frame(_T_S2_CIPHERTEXT, {"k": params.k, "n": params.n},
                  _packed(_r_bits(params), a, b))


def s2_lwe_to_wire(params: s2.Params, lwe: s1.LWE) -> bytes:
    """Scheme-2 digit LWE batch (split_ciphertext and bootstrap outputs)."""
    parts, bshape = _lwe_parts(lwe.a, lwe.b, _r_bits(params), "LWE")
    return _frame(_T_S2_LWE, {"k": params.k, "n": params.n, "shape": bshape}, parts)


def bootstrap_key_to_wire_seeded(bkey) -> bytes:
    """Seeded bootstrap-key frame (scheme 1 or 2): the a-column's two seed
    words and the b-column residues, half the bytes of `to_wire(bkey)`."""
    if bkey.seed is None:
        raise ValueError("bootstrap key carries no seed (loaded from a non-seeded "
                         "checkpoint?) — use to_wire instead")
    p = bkey.params
    scheme = 2 if isinstance(p, s2.Params) else 1
    seed = np.asarray(bkey.seed, dtype=np.uint32)
    meta = {"scheme": scheme, "n": p.n, "seedwords": int(seed.size),
            "stream": _SEED_STREAM[scheme]}
    if scheme == 2:
        meta["k"] = p.k
    return _frame(_T_BKEY_SEEDED, meta, [seed, *_packed(_key_bits(p), bkey.hat[:, :, 1])])


def _seeded_from(meta: dict, payload, ctx, dev):
    scheme = meta.get("scheme", 1)
    stream = meta.get("stream", 1)
    if scheme not in _SEED_STREAM:
        raise ValueError(f"seeded frame of unknown scheme {scheme}")
    if meta["seedwords"] != 2:
        raise ValueError(f"seeded frame with {meta['seedwords']} seed words; a key has 2")
    if stream != _SEED_STREAM[scheme]:
        raise ValueError(
            f"seeded bootstrap-key frame uses a-column stream version {stream}, but this "
            f"build regenerates stream {_SEED_STREAM[scheme]} for scheme {scheme} — loading "
            f"would silently rebuild a mismatched key. Re-export the key from a build that "
            f"writes stream {_SEED_STREAM[scheme]}, or use the full (non-seeded) wire format."
        )
    if scheme == 2:
        prm, mod = s2.Params.create(meta["k"], n=meta["n"]), s2
    else:
        prm, mod = Params.create(meta["n"]), s1
    c = ctx if ctx is not None else mod.make_context(prm, device=dev)
    seed = np.frombuffer(payload[:8], dtype=np.uint32).copy()
    n, l, L, m = prm.n, prm.num_digits, prm.num_limbs, prm.m
    b_hat = native.unpack_uint(payload[8:], n * 2 * l * L * m, _key_bits(prm))
    b_hat = torch.from_numpy(b_hat.view(np.int32)).reshape(n, 2 * l, L, m)
    return mod.BootstrapKey.from_seeded(prm, c, seed, b_hat)


def _full_key_from(params: Params, payload, dev) -> s1.BootstrapKey:
    """Type 3: hat (n, 2l, 2, L, m); the companions recomputed a chunk of
    key indices at a time."""
    n, l, L, m = params.n, params.num_digits, params.num_limbs, params.m
    hat = native.unpack_uint(payload, n * 2 * l * 2 * L * m, _key_bits(params))
    hat = interop.bits_tensor(hat, dev).reshape(n, 2 * l, 2, L, m)
    p = torch.tensor(params.moduli, dtype=torch.int64, device=dev).reshape(L, 1)
    shoup = torch.empty_like(hat)
    chunk = s1._key_chunk(params)
    for i in range(0, n, chunk):
        shoup[i:i + chunk] = mm.bits32(s1._shoup_companion(mm.u32(hat[i:i + chunk]), p))
    return s1.BootstrapKey(params, hat, shoup)


def from_wire(raw, ctx=None, device=None):
    """Parse a wire frame (CRC verified) back into its object: on
    `ctx.device` when a context is given, else on `device`, else on the
    card. `ctx` is used only by the seeded bootstrap-key frame, which
    transforms the a-column it draws again; without one it builds a
    context from the frame's parameters. Scheme-2 frames return
    (params, a, b) and (params, LWE)."""
    type_code, meta, payload = _unframe(raw)
    dev = ctx.device if ctx is not None else s1.resolve_device(device)
    if type_code == _T_BKEY_SEEDED:
        return _seeded_from(meta, payload, ctx, dev)
    if type_code == _T_S2_CIPHERTEXT:
        p2 = s2.Params.create(meta["k"], n=meta["n"])
        rd = _Reader(payload)
        a, b = rd.uint(p2.n, _r_bits(p2)), rd.uint(p2.n, _r_bits(p2))
        return p2, interop.tensor(a, dev), interop.tensor(b, dev)
    if type_code == _T_S2_LWE:
        p2 = s2.Params.create(meta["k"], n=meta["n"])
        return p2, _lwe_from(payload, p2.n, tuple(meta["shape"]), _r_bits(p2), dev)
    if type_code == _T_ENCRYPTED_BIT:
        n = meta["n"]
        if "shape" in meta:
            bshape = tuple(meta["shape"])
        else:  # frames written before the shape field: 1-D batch or scalar
            legacy = meta.get("batch", 0)
            bshape = (legacy,) if legacy else ()
        return s1.EncryptedBit(_lwe_from(payload, n, bshape, (16 * n).bit_length() - 1, dev))
    params = Params.create(meta["n"])
    if type_code == _T_PRIVATE_KEY:
        bits = native.unpackbits(payload, params.n)
        return s1.PrivateKey(params, interop.tensor(bits, dev))
    if type_code == _T_PUBLIC_KEY:
        w = max(q.bit_length() for q in params.q_factors)
        Lq = len(params.q_factors)
        shape = (params.n,) if Lq == 1 else (Lq, params.n)
        rd = _Reader(payload)
        k0, k1 = (rd.uint(Lq * params.n, w).reshape(shape) for _ in range(2))
        return s1.PublicKey(params, interop.tensor(k0, dev), interop.tensor(k1, dev))
    if type_code == _T_BOOTSTRAP_KEY:
        return _full_key_from(params, payload, dev)
    if type_code in (_T_PACKED_CT, _T_CIPHERTEXT):
        length = params.n if type_code == _T_PACKED_CT else params.m
        rd = _Reader(payload)
        a, b = rd.uint(length, _r_bits(params)), rd.uint(length, _r_bits(params))
        cls = s1.PackedCiphertext if type_code == _T_PACKED_CT else s1.Ciphertext
        return cls(params, s1.RLWE(interop.tensor(a, dev), interop.tensor(b, dev)))
    if type_code == _T_PRIVATE_CT:
        return private_ciphertext_from_bytes(params, payload, dev)
    if type_code == _T_PUBLIC_CT:
        return public_ciphertext_from_bytes(params, payload, dev)
    raise ValueError(f"unknown wire type code {type_code}")


# -- key checkpoints (npz) -----------------------------------------------------


def _params_meta(params) -> str:
    if isinstance(params, Params):
        return json.dumps({"scheme": 1, "n": params.n})
    if isinstance(params, s2.Params):
        return json.dumps({"scheme": 2, "k": params.k, "n": params.n})
    raise TypeError(type(params))


def _params_from_meta(meta: str):
    d = json.loads(meta)
    if d["scheme"] == 1:
        return Params.create(d["n"])
    # "n" absent in older checkpoints (always the paper's default 1024)
    return s2.Params.create(d["k"], n=d.get("n"))


_KEY_FIELDS = {"PrivateKey": ("key",), "PublicKey": ("k0", "k1"),
               "BootstrapKey": ("hat", "hat_shoup")}
_SAVABLE = (s1.PrivateKey, s1.PublicKey, s1.BootstrapKey,
            s2.PrivateKey, s2.PublicKey, s2.BootstrapKey)


def save(path, obj) -> None:
    """Checkpoint a key object of either scheme to .npz, uint32 arrays
    under the JAX package's field names."""
    tp = type(obj)
    if tp not in _SAVABLE:
        raise TypeError(f"cannot serialize {tp}")
    arrays = {f: interop.to_numpy(getattr(obj, f)) for f in _KEY_FIELDS[tp.__name__]}
    np.savez_compressed(
        path,
        __magic__=np.frombuffer(MAGIC.encode(), dtype=np.uint8),
        __type__=np.frombuffer(tp.__name__.encode(), dtype=np.uint8),
        __params__=np.frombuffer(_params_meta(obj.params).encode(), dtype=np.uint8),
        **arrays,
    )


def load(path, device=None):
    """Restore a key object saved with `save` by either package, on
    `device` (the card by default); Params re-derived."""
    dev = s1.resolve_device(device)
    with np.load(path) as z:
        magic = z["__magic__"].tobytes().decode()
        if magic != MAGIC:
            raise ValueError(f"bad magic {magic!r}")
        tname = z["__type__"].tobytes().decode()
        if tname not in _KEY_FIELDS:
            raise ValueError(f"unknown checkpoint type {tname!r}")
        params = _params_from_meta(z["__params__"].tobytes().decode())
        mod = s2 if isinstance(params, s2.Params) else s1
        cls = getattr(mod, tname)
        fields = {}
        for k, v in z.items():
            if k.startswith("__"):
                continue
            to_tensor = interop.bits_tensor if k.startswith("hat") else interop.tensor
            fields[k] = to_tensor(v, dev)
        return cls(params, **fields)
