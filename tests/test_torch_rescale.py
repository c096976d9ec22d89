"""The exact Q->r switch's CUDA kernel (csrc/rescale.cu) against its plain
version, bit for bit, on a card; and its host constants, on any machine.

The card tests skip without a CUDA device. Nothing here imports JAX or the
JAX package:

    python -m pytest tests/test_torch_rescale.py --noconftest -q
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import sgfhe_tpu_torch as T  # noqa: E402
from sgfhe_tpu_torch.ops import rns  # noqa: E402

# (name, moduli, r): K = 1 but at Params(16384) in round mode (A = 2r = 2^19)
MODULI = {
    "params64": (T.Params.create(64).moduli, T.Params.create(64).r),
    "params512": (T.Params.create(512).moduli, T.Params.create(512).r),
    "params16384": (T.Params.create(16384).moduli, T.Params.create(16384).r),
    "scheme2-k4": (T.Scheme2.Params.create(4).moduli, T.Scheme2.Params.create(4).r),
}


def _int_of(limbs) -> int:
    return sum(int(v) << (32 * j) for j, v in enumerate(limbs))


@pytest.mark.parametrize("round_result", [True, False], ids=["round", "floor"])
@pytest.mark.parametrize("name", list(MODULI))
def test_switch_consts_recombine(name, round_result):
    """The words the kernel takes by value hold A*w_i, B + K*C and i*C in
    nl limbs, the moduli with inv(p_j) mod p_i and its Shoup companion, the
    float32 factors, K and the mask, as the switch's definition gives them."""
    moduli, r = MODULI[name]
    L = len(moduli)
    Q = int(np.prod([int(p) for p in moduli], dtype=object))
    w = [int(np.prod([int(p) for p in moduli[:i]], dtype=object)) for i in range(L)]
    A, B, C = (2 * r, Q, 2 * Q) if round_result else (r, 0, Q)
    K = max(1, -(-(3 * (L + 2) * A) // (1 << 23)))
    nl = (A * (Q - 1) + B + (K + 1) * C).bit_length() // 32 + 1
    sc = rns.switch_consts(moduli, r, round_result)
    assert (sc.A, sc.B, sc.C, sc.K, sc.nl, sc.weights) == (A, B, C, K, nl, tuple(w))
    assert K == (2 if name == "params16384" and round_result else 1)
    assert nl <= rns.SWITCH_NLMAX
    assert rns.switch_consts(moduli, r, round_result) is sc  # cached
    c = rns.switch_fields(sc.words)
    assert [int(v) for v in c["p"][:L]] == list(moduli)
    for i in range(L):
        for j in range(i):
            inv = int(c["inv_pj"][i, j])
            assert inv * moduli[j] % moduli[i] == 1
            assert int(c["inv_pj_s"][i, j]) == (inv << 32) // moduli[i]
        assert _int_of(c["aw"][i]) == A * w[i]
    assert not c["aw"][L:].any() and not c["aw"][:, nl:].any()
    assert _int_of(c["bkc"]) == B + K * C
    assert [_int_of(c["ic"][i]) for i in range(2 * K)] == [i * C for i in range(1, 2 * K + 1)]
    assert not c["ic"][2 * K:].any()
    f = c["f"].view(np.float32)
    assert f[:L].tolist() == [np.float32(A * wi / C) for wi in w] == list(sc.factors)
    assert np.asarray(c["f_b"]).view(np.float32) == (np.float32(B / C) if B else 0.0)
    assert (int(c["k"]), int(c["mask"])) == (K, r - 1)


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


def _values(moduli, r, round_result, count, rng):
    """count values in [0, Q): 0, Q - 1, each side of rounding boundaries
    ceil((j*C - B) / A) (where the float32 estimate is most often off by
    one), the rest uniform."""
    Q = int(np.prod([int(p) for p in moduli], dtype=object))
    A, B, C = (2 * r, Q, 2 * Q) if round_result else (r, 0, Q)
    xs = [0, Q - 1]
    for j in [1, 2, 3, A // 3, A // 2, A - 2, A - 1]:
        b = -(-(j * C - B) // A)
        xs += [min(max(b + e, 0), Q - 1) for e in (-2, -1, 0, 1)]
    while len(xs) < count:
        xs.append(int(rng.integers(0, 1 << 62)) * int(rng.integers(0, 1 << 62)) % Q)
    return xs[:count]


@pytest.mark.cuda
@pytest.mark.parametrize("round_result", [True, False], ids=["round", "floor"])
@pytest.mark.parametrize("name", list(MODULI))
def test_rescale_kernel_equals_plain_on_card(name, round_result):
    """The kernel at (B, L, n), (B, L, 1) and (L, n), contiguous and as
    strided views on the card (a column of a wider tensor, as the main
    path's b; every third coefficient), == the plain version on the CPU,
    bit for bit; one launch a call."""
    dev = _card()
    moduli, r = MODULI[name]
    L = len(moduli)
    rng = np.random.default_rng(sum(moduli) + round_result)
    ctx_cpu = rns.build_context(moduli).device_context("cpu")
    ctx_dev = rns.build_context(moduli).device_context(dev)
    B, n = 8, 512
    xs = _values(moduli, r, round_result, B * n, rng)
    res = torch.tensor([[v % p for p in moduli] for v in xs], dtype=torch.int64)
    wide = res.reshape(B, n, L).transpose(1, 2).contiguous()  # (B, L, n)
    wide_dev = wide.to(dev)
    views = (lambda t: t, lambda t: t[..., :1], lambda t: t[:, :, 5:6].contiguous(),
             lambda t: t[0], lambda t: t[..., 1::3])
    for view in views:
        want = rns.rescale_exact(ctx_cpu, view(wide), r, moduli, round_result)
        before = rns.rescale_exact.launches
        got = rns.rescale_exact(ctx_dev, view(wide_dev), r, moduli, round_result)
        torch.cuda.synchronize()
        assert rns.rescale_exact.launches == before + 1
        assert got.dtype == torch.int64 and got.shape == want.shape
        assert torch.equal(got.cpu(), want)
    Q = int(np.prod([int(p) for p in moduli], dtype=object))
    truth = [((2 * v * r + Q) // (2 * Q) if round_result else v * r // Q) % r for v in xs[:n]]
    assert rns.rescale_exact(ctx_cpu, wide[:1], r, moduli, round_result)[0].tolist() == truth
