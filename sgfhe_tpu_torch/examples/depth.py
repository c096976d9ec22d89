"""Bootstrap depth soak (counterpart of examples/depth.py; reference
examples/depth.jl:63-78): chain gate generations, the outputs of generation
g feeding generation g+1, and check every generation. The noise-budget
regression test: any systematic noise growth would flip a bit within a
few generations.

Usage: python -m sgfhe_tpu_torch.examples.depth [generations=100] [n=64] [prune=0]
       [--device cpu]
"""

from __future__ import annotations

import time

import numpy as np
import torch

import sgfhe_tpu_torch as T
from sgfhe_tpu_torch.debug.noise import lwe_error
from sgfhe_tpu_torch.examples import describe, parse


def main(argv=None) -> dict:
    (generations, n, prune), dev, _ = parse(argv, (100, 64, 0))
    print(f"device: {describe(dev)}")
    params = T.Params.create(n)
    ctx = T.make_context(params, device=dev)
    g = torch.Generator().manual_seed(0)
    sk = T.PrivateKey.create(params, g, device=dev)
    bkey = T.BootstrapKey.create(ctx, sk, g)

    msg = torch.randint(0, 2, (params.n,), generator=g)
    bits = T.split_ciphertext(T.encrypt(sk, g, msg))

    # pair up: gates on halves; each generation feeds (AND, XOR) outputs back
    half = params.n // 2
    cur1 = T.LWE(bits.lwe.a[:half], bits.lwe.b[:half])
    cur2 = T.LWE(bits.lwe.a[half:], bits.lwe.b[half:])
    y1 = msg[:half].bool().numpy()
    y2 = msg[half:].bool().numpy()

    t0 = time.time()
    max_err = 0
    for gen in range(generations):
        and_l, or_l, xor_l = T.bootstrap_batch(
            params, ctx, bkey.hat, bkey.hat_shoup, cur1, cur2, prune=prune
        )
        e_and, e_or, e_xor = y1 & y2, y1 | y2, y1 ^ y2
        for name, lwe, want in (("AND", and_l, e_and), ("OR", or_l, e_or),
                                ("XOR", xor_l, e_xor)):
            got = T.decrypt_bit(sk, T.EncryptedBit(lwe)).cpu().numpy()
            if not (got == want).all():
                raise SystemExit(f"FAIL: {name} wrong at generation {gen}")
        err = int(np.abs(lwe_error(sk, T.EncryptedBit(and_l), e_and)).max())
        max_err = max(max_err, err)
        # feed forward: AND and XOR become the next generation's inputs
        cur1, cur2 = and_l, xor_l
        y1, y2 = e_and, e_xor
        if (gen + 1) % 10 == 0:
            print(
                f"generation {gen + 1}/{generations} ok "
                f"(max |err| so far {max_err}, boundary {params.Dr // 2})",
                flush=True,
            )
    dt = time.time() - t0
    print(
        f"PASS: {generations} chained generations x {half} gates in {dt:.1f}s; "
        f"max |noise| {max_err} vs paper bound {params.Dr // 4} "
        f"and decision boundary {params.Dr // 2}"
    )
    return {"generations": generations, "seconds": dt, "max_err": max_err}


if __name__ == "__main__":
    main()
