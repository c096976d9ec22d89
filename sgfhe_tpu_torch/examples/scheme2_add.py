"""Scheme-2 k-bit homomorphic arithmetic on the card (counterpart of
examples/scheme2_add.py; eprint 2019/521).

Runs the functional bootstrap at the paper's size (n = 1024, k
configurable): encrypts two vectors of k-bit digits, computes
digit/carry = add_with_carry(x, y) in one batch, decrypts and checks every
result, and reports adds/s and the observed phase noise against the
decision boundary Dr/2; then the same for mul, and for sub_wide and
min_max_wide over W = 3 digits.

Usage: python -m sgfhe_tpu_torch.examples.scheme2_add [k=1] [batch=64] [n=1024]
       [prune=0] [--device cpu]
(pass a smaller power of four as n for a quick run; prune > 0 takes the
approximate-gadget fast mode.)
"""

from __future__ import annotations

import time

import numpy as np
import torch

from sgfhe_tpu_torch.examples import describe, parse, sync
from sgfhe_tpu_torch.models import bootstrap2 as bs2
from sgfhe_tpu_torch.models import scheme2 as s2
from sgfhe_tpu_torch.models import wideint as wi
from sgfhe_tpu_torch.models.scheme1 import LWE

ITERS = 3


def _timed(dev, fn):
    """(result, seconds a call): one first call, then ITERS timed."""
    t0 = time.time()
    out = fn()
    sync(dev)
    first = time.time() - t0
    t0 = time.time()
    for _ in range(ITERS):
        out = fn()
    sync(dev)
    return out, first, (time.time() - t0) / ITERS


def _noise(sk, lwes_and_values) -> int:
    return max(int(bs2.lwe_phase_noise(sk, lwe, torch.as_tensor(v, device=lwe.b.device))
                   .abs().max()) for lwe, v in lwes_and_values)


def _digits(sk, lwe) -> np.ndarray:
    return bs2.decrypt_lwe(sk, lwe).cpu().numpy()


def main(argv=None) -> dict:
    (k, batch, n, prune), dev, _ = parse(argv, (1, 64, 1024, 0))
    print(f"device: {describe(dev)}", flush=True)
    t0 = time.time()
    params = s2.Params.create(k, n=n)
    ctx = s2.make_context(params, device=dev)
    g = torch.Generator().manual_seed(1)
    sk = s2.PrivateKey.create(params, g, device=dev)
    print(
        f"Params(k={k}): n={params.n} m={params.m} r={params.r} "
        f"L={params.num_limbs} Q~2^{params.Q.bit_length()} "
        f"[{time.time() - t0:.1f}s]",
        flush=True,
    )
    t0 = time.time()
    bkey = s2.BootstrapKey.create(ctx, sk, g)
    sync(dev)
    kb = bkey.hat.numel() * 8 / 2**20
    print(f"BootstrapKey: {kb:.0f} MiB (hat+shoup) [{time.time() - t0:.1f}s]", flush=True)

    rng = np.random.default_rng(7)
    K = 2**k
    x = rng.integers(0, K, params.n)
    y = rng.integers(0, K, params.n)
    lx = bs2.split_ciphertext(params, *s2.encrypt(sk, g, torch.as_tensor(x)))
    ly = bs2.split_ciphertext(params, *s2.encrypt(sk, g, torch.as_tensor(y)))
    idx = np.arange(batch) % params.n
    ti = torch.as_tensor(idx, device=lx.a.device)
    lx = LWE(lx.a[ti], lx.b[ti])
    ly = LWE(ly.a[ti], ly.b[ti])
    rates = {}

    (digit, carry), first, dt = _timed(
        dev, lambda: bs2.add_with_carry(params, ctx, bkey, lx, ly, prune=prune))
    print(f"first batch (prune={prune}): {first:.1f}s", flush=True)
    z = x[idx] + y[idx]
    if not ((_digits(sk, digit) == z % K).all() and (_digits(sk, carry) == z // K).all()):
        raise SystemExit("FAIL: wrong digit/carry")
    rates["adds"] = batch / dt
    print(
        f"scheme2 add_with_carry k={k} prune={prune}: {batch} adds in "
        f"{dt * 1e3:.1f} ms -> {rates['adds']:.1f} adds/s (digit+carry verified); "
        f"max |noise| {_noise(sk, [(digit, z % K), (carry, z // K)])} "
        f"vs boundary {params.Dr // 2}",
        flush=True,
    )

    # k-bit multiplication (quarter-squares, 3 rotation rounds / 7 lanes)
    (lo, hi), first, dt = _timed(dev, lambda: bs2.mul(params, ctx, bkey, lx, ly))
    print(f"mul first batch: {first:.1f}s", flush=True)
    prod = x[idx] * y[idx]
    if not ((_digits(sk, lo) == prod % K).all() and (_digits(sk, hi) == prod // K).all()):
        raise SystemExit("FAIL: wrong product digits")
    rates["muls"] = batch / dt
    print(
        f"scheme2 mul k={k}: {batch} muls in {dt * 1e3:.1f} ms -> "
        f"{rates['muls']:.1f} muls/s (lo+hi digits verified); max |noise| "
        f"{_noise(sk, [(lo, prod % K), (hi, prod // K)])} vs boundary {params.Dr // 2}",
        flush=True,
    )

    # wide subtraction + comparison (models/wideint.py): W-digit two's
    # complement, W rotations give the difference and the [x >= y] flag
    W = 3
    B = min(batch, params.n)
    xw = rng.integers(0, 2 ** (k * W), B)
    yw = rng.integers(0, 2 ** (k * W), B)
    yw[0] = xw[0]  # force one tie
    xs = wi.encrypt_wide(sk, g, xw, W)
    ys = wi.encrypt_wide(sk, g, yw, W)
    (diff, ge), first, dt = _timed(dev, lambda: wi.sub_wide(params, ctx, bkey, xs, ys))
    print(f"sub first batch: {first:.1f}s", flush=True)
    if not ((wi.decrypt_wide(sk, diff) == (xw - yw) % 2 ** (k * W)).all()
            and (_digits(sk, ge) == (xw >= yw)).all()):
        raise SystemExit("FAIL: wrong difference / >= flag")
    rates["subs"] = B / dt
    print(
        f"scheme2 sub_wide k={k} W={W}: {B} subs in {dt * 1e3:.1f} ms -> "
        f"{rates['subs']:.1f} subs/s (diff + [x>=y] flag verified)",
        flush=True,
    )

    # encrypted min/max (one ge_wide comparison + one shared 4W-lane mux)
    (mins, maxs), first, dt = _timed(dev, lambda: wi.min_max_wide(params, ctx, bkey, xs, ys))
    print(f"min_max first batch: {first:.1f}s", flush=True)
    if not ((wi.decrypt_wide(sk, mins) == np.minimum(xw, yw)).all()
            and (wi.decrypt_wide(sk, maxs) == np.maximum(xw, yw)).all()):
        raise SystemExit("FAIL: wrong min/max")
    rates["min_max"] = B / dt
    print(
        f"scheme2 min_max_wide k={k} W={W}: {B} pairs in {dt * 1e3:.1f} ms -> "
        f"{rates['min_max']:.1f} min+max/s (both extrema verified)",
        flush=True,
    )
    return rates


if __name__ == "__main__":
    main()
