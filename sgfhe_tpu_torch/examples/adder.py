"""Encrypted ripple-carry adder through the circuit-evaluation layer
(counterpart of examples/adder.py).

Builds a boolean circuit once, then evaluates it on encrypted inputs with
all gate-level parallelism in the batch axis of the rotation kernels: the
evaluator shares one bootstrap among AND/OR/XOR of the same pair and runs
B independent additions at once (SIMD over instances). Every sum is
decrypted and checked.

Usage: python -m sgfhe_tpu_torch.examples.adder [nbits=8] [n=64] [instances=4]
       [--device cpu]
"""

from __future__ import annotations

import time

import numpy as np
import torch

import sgfhe_tpu_torch as T
from sgfhe_tpu_torch import circuit as C
from sgfhe_tpu_torch.examples import describe, parse, sync


def main(argv=None) -> dict:
    (nbits, n, B), dev, _ = parse(argv, (8, 64, 4))
    print(f"device: {describe(dev)}")
    params = T.Params.create(n)
    ctx = T.make_context(params, device=dev)
    g = torch.Generator().manual_seed(1234)
    sk = T.PrivateKey.create(params, g, device=dev)
    print(f"building bootstrap key (n={n})...")
    bkey = T.BootstrapKey.create(ctx, sk, g)

    circ = C.ripple_adder(nbits)
    num_gates = sum(1 for w in circ._wires if w.op in ("and", "or", "xor"))
    print(
        f"{nbits}-bit adder: {circ.num_bootstraps} bootstraps "
        f"(pair-shared from {num_gates} binary gates), depth {circ.depth}, "
        f"{B} instances in SIMD"
    )

    rng = np.random.default_rng(99)
    pairs = [
        (int(rng.integers(0, 1 << nbits)), int(rng.integers(0, 1 << nbits)))
        for _ in range(B)
    ]
    # encrypt each instance's 2*nbits input bits (one message per instance)
    per_inst = []
    for a, b in pairs:
        msg = torch.zeros(params.n, dtype=torch.int64)
        for j in range(nbits):
            msg[j] = (a >> j) & 1
            msg[nbits + j] = (b >> j) & 1
        per_inst.append(T.split_ciphertext(T.encrypt(sk, g, msg)).lwe)
    inputs = [
        T.EncryptedBit(T.LWE(
            torch.stack([per_inst[i].a[j] for i in range(B)]),
            torch.stack([per_inst[i].b[j] for i in range(B)]),
        ))
        for j in range(2 * nbits)
    ]

    t0 = time.perf_counter()
    outs = C.evaluate(circ, params, ctx, bkey, inputs)
    sync(dev)
    t_first = time.perf_counter() - t0
    t0 = time.perf_counter()
    outs = C.evaluate(circ, params, ctx, bkey, inputs)
    sync(dev)
    t_steady = time.perf_counter() - t0

    dec = [T.decrypt_bit(sk, o).long().cpu().numpy() for o in outs]
    ok = True
    for i, (a, b) in enumerate(pairs):
        total = sum(int(dec[j][i]) << j for j in range(nbits + 1))
        status = "ok" if total == a + b else "WRONG"
        ok &= total == a + b
        print(f"  {a} + {b} = {total}  [{status}]")
    rate = circ.num_bootstraps * B / t_steady
    print(
        f"evaluate: {t_first:.2f}s first call, "
        f"{t_steady:.2f}s steady ({rate:.1f} bootstraps/s incl. scheduling overhead)"
    )
    if not ok:
        raise SystemExit("FAIL: adder mismatch")
    print("PASS")
    return {"pairs": pairs, "seconds": t_steady, "bootstraps_per_s": rate}


if __name__ == "__main__":
    main()
