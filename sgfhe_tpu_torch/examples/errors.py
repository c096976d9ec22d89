"""Empirical noise measurement (counterpart of examples/errors.py; reference
examples/errors.jl): the LWE error after encryption, splitting,
bootstrapping and packing, against the paper's bounds (eprint 2018/637).

Usage: python -m sgfhe_tpu_torch.examples.errors [n=64] [trials=4] [--device cpu]
"""

from __future__ import annotations

import numpy as np
import torch

import sgfhe_tpu_torch as T
from sgfhe_tpu_torch.debug.noise import lwe_error, noise_budget_report, rlwe_error
from sgfhe_tpu_torch.examples import describe, parse


def main(argv=None) -> dict:
    (n, trials), dev, _ = parse(argv, (64, 4))
    print(f"device: {describe(dev)}")
    params = T.Params.create(n)
    ctx = T.make_context(params, device=dev)
    g = torch.Generator().manual_seed(0)
    sk = T.PrivateKey.create(params, g, device=dev)
    bkey = T.BootstrapKey.create(ctx, sk, g)

    print(f"n={n}: r={params.r}, Dr={params.Dr}, paper bound Dr/4={params.Dr // 4}")
    enc_errs, boot_errs, pack_errs = [], [], []
    for _ in range(trials):
        msg = torch.randint(0, 2, (params.n,), generator=g)
        ct = T.encrypt(sk, g, msg)
        enc_errs.append(np.abs(rlwe_error(sk, ct, msg)).max())

        bits = T.split_ciphertext(ct)
        lwe1 = T.LWE(bits.lwe.a[0::2], bits.lwe.b[0::2])
        lwe2 = T.LWE(bits.lwe.a[1::2], bits.lwe.b[1::2])
        and_l, or_l, xor_l = T.bootstrap_batch(
            params, ctx, bkey.hat, bkey.hat_shoup, lwe1, lwe2
        )
        y1, y2 = msg[0::2].bool().numpy(), msg[1::2].bool().numpy()
        boot_errs.append(np.abs(lwe_error(sk, T.EncryptedBit(and_l), y1 & y2)).max())

        packed = T.pack_encrypted_bits(params, ctx, bkey, bits)
        pack_errs.append(np.abs(rlwe_error(sk, packed, msg)).max())

    print(f"encrypt max|err|:   {max(enc_errs)}  (budget Dr/2 = {params.Dr // 2})")
    print(f"bootstrap max|err|: {max(boot_errs)}")
    print(f"pack max|err|:      {max(pack_errs)}")
    rep = noise_budget_report(sk, T.EncryptedBit(and_l), y1 & y2)
    print("bootstrap noise report:", rep)
    worst = max(max(enc_errs), max(boot_errs), max(pack_errs))
    if not (rep["ok"] and worst < params.Dr // 2):
        raise SystemExit(f"FAIL: noise {worst} reaches the decision boundary "
                         f"Dr/2 = {params.Dr // 2}")
    return {"encrypt": int(max(enc_errs)), "bootstrap": int(max(boot_errs)),
            "pack": int(max(pack_errs)), "report": rep}


if __name__ == "__main__":
    main()
