"""Scaling-efficiency harness: bootstrap gates/s against the number of
ranks (counterpart of examples/scaling.py), through
parallel/sharded.bootstrap_batch_sharded.

The world comes from torch.distributed: on one card a world of one rank
over NCCL; under torchrun every rank of its world, for instance two gloo
ranks on the CPU:

    torchrun --nproc-per-node 2 -m sgfhe_tpu_torch.examples.scaling 256 64 --device cpu

where the efficiency is indicative only (the ranks share the host's
cores); what such a run proves is that every mesh computes the gates
right. The gates are bits of two encrypted messages, and after the rates
every gate of the whole world's mesh is decrypted against the AND, OR and
XOR truth tables.

Usage: python -m sgfhe_tpu_torch.examples.scaling [batch=256] [n=64] [--device cpu]
"""

from __future__ import annotations

import sys

import torch
import torch.distributed as dist

import sgfhe_tpu_torch as T
from sgfhe_tpu_torch.examples import describe, parse
from sgfhe_tpu_torch.parallel import distributed
from sgfhe_tpu_torch.parallel import mesh as mesh_mod
from sgfhe_tpu_torch.parallel import sharded

ITERS = 3


def _encrypted_bits(params, sk, g, bits: torch.Tensor) -> T.LWE:
    """bits (B,) encrypted n at a time and split: B LWEs."""
    n = params.n
    padded = torch.cat([bits, bits.new_zeros(-len(bits) % n)])
    parts = [T.split_ciphertext(T.encrypt(sk, g, padded[i:i + n])).lwe
             for i in range(0, len(padded), n)]
    B = len(bits)
    return T.LWE(torch.cat([p.a for p in parts])[:B], torch.cat([p.b for p in parts])[:B])


def main(argv=None) -> list:
    (batch, n), dev, _ = parse(argv, (256, 64))
    joined = distributed.init_world(dev)
    try:
        params = T.Params.create(n)
        ctx = T.make_context(params, device=dev)
        g = torch.Generator().manual_seed(0)
        sk = T.PrivateKey.create(params, g, device=dev)
        bkey = T.BootstrapKey.create(ctx, sk, g)
        m1, m2 = torch.randint(0, 2, (2, batch), generator=g)
        lwe1, lwe2 = (_encrypted_bits(params, sk, g, m) for m in (m1, m2))
        rank0 = dist.get_rank() == 0
        if rank0:
            print(f"devices: {distributed.process_count()} x {describe(dev)} over "
                  f"{dist.get_backend()}, batch {batch}, Params({n})", flush=True)
        rows = distributed.scaling_report(params, ctx, bkey, lwe1, lwe2, iters=ITERS,
                                          out=sys.stdout)
        out = sharded.bootstrap_batch_sharded(params, ctx, bkey, lwe1, lwe2,
                                              mesh_mod.make_mesh())
        y1, y2 = m1.to(dev).bool(), m2.to(dev).bool()
        for name, lwe, want in zip(("AND", "OR", "XOR"), out, (y1 & y2, y1 | y2, y1 ^ y2)):
            if not torch.equal(T.decrypt_bit(sk, T.EncryptedBit(lwe)), want):
                raise SystemExit(f"FAIL: wrong {name} gates")
        if rank0:
            print(f"PASS: {batch} gates on the {distributed.process_count()}-rank mesh, truth "
                  f"tables AND/OR/XOR hold", flush=True)
        return rows
    finally:
        if joined:
            dist.destroy_process_group()


if __name__ == "__main__":
    main()
