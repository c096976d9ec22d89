"""Scheme-2 smoke (counterpart of examples/scheme2_demo.py; reference
examples/test_scheme2.jl): build params and keys, encrypt and decrypt
k-bit digits with both key types, and with --bkey build the bootstrap key.

Usage: python -m sgfhe_tpu_torch.examples.scheme2_demo [k=1] [n=1024] [--bkey]
       [--device cpu]
(n, which the JAX script does not take, is the paper's 1024 by default; a
smaller power of four makes a quick run.)
"""

from __future__ import annotations

import torch

from sgfhe_tpu_torch.examples import describe, parse
from sgfhe_tpu_torch.models import scheme2 as s2


def main(argv=None) -> dict:
    (k, n), dev, flags = parse(argv, (1, 1024), flags=("--bkey",))
    print(f"device: {describe(dev)}")
    params = s2.Params.create(k, n)
    print(
        f"k={k}: n={params.n} r={params.r} q~2^{params.q.bit_length()} "
        f"Q~2^{params.Q.bit_length()} limbs={params.moduli}"
    )
    ctx = s2.make_context(params, device=dev)
    g = torch.Generator().manual_seed(0)
    sk = s2.PrivateKey.create(params, g, device=dev)
    pk = s2.PublicKey.create(ctx, sk, g)

    msg = torch.randint(0, 2**k, (params.n,), generator=g).to(dev)
    a, b = s2.encrypt(sk, g, msg)
    if not torch.equal(s2.decrypt(sk, a, b), msg):
        raise SystemExit("FAIL: private k-bit roundtrip")
    print("private k-bit roundtrip ok")

    a, b = s2.encrypt(pk, ctx, g, msg)
    if not torch.equal(s2.decrypt(sk, a, b), msg):
        raise SystemExit("FAIL: public k-bit roundtrip")
    print("public k-bit roundtrip ok")

    shape = None
    if "--bkey" in flags:
        bkey = s2.BootstrapKey.create(ctx, sk, g)
        shape = tuple(bkey.hat.shape)
        print("bootstrap key:", shape)
    return {"params": params, "bkey_shape": shape}


if __name__ == "__main__":
    main()
