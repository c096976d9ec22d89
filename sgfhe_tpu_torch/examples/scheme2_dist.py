"""Scheme-2 add_with_carry through the tensor-parallel rotation with a
real bootstrap key (counterpart of examples/scheme2_dist.py): the
giant-key path, on which each rank needs 1/D of the key (reference
parameter surface src/fhe2.jl:36-39).

Full key generation, conversion to the dist-hat order (m2 = 128,
m1 = m / 128, as the JAX script has it; each rank converts its own rows),
one add_with_carry_dist batch over the tp axis of the world's mesh,
digit and carry decrypted and checked, and the phase noise against the
Dr/2 boundary. The world comes from torch.distributed: on one card a
world of one rank over NCCL (at k = 4 the key and its dist-order copy
take about 16 GiB), under torchrun every rank of its world. The single-
device key is kept and returned, so that a caller can hold the sharded
result against the single-device rotation.

Usage: python -m sgfhe_tpu_torch.examples.scheme2_dist [k=4] [batch=2] [prune=0]
       [n=1024] [--device cpu]
(n, which the JAX script does not take, shrinks the ring for a quick run.)
"""

from __future__ import annotations

import time

import numpy as np
import torch
import torch.distributed as dist

from sgfhe_tpu_torch.examples import describe, parse, sync
from sgfhe_tpu_torch.models import bootstrap2 as bs2
from sgfhe_tpu_torch.models import scheme2 as s2
from sgfhe_tpu_torch.models.scheme1 import LWE
from sgfhe_tpu_torch.parallel import distributed
from sgfhe_tpu_torch.parallel import mesh as mesh_mod
from sgfhe_tpu_torch.parallel import rotate_dist as rd

M2 = 128


def main(argv=None) -> dict:
    (k, batch, prune, n), dev, _ = parse(argv, (4, 2, 0, 1024))
    joined = distributed.init_world(dev)
    try:
        rank0 = dist.get_rank() == 0

        def say(text):
            if rank0:
                print(text, flush=True)

        say(f"device: {describe(dev)}, {distributed.process_count()} rank(s) over "
            f"{dist.get_backend()}")
        t0 = time.time()
        params = s2.Params.create(k, n=n)
        ctx = s2.make_context(params, device=dev)
        g = torch.Generator().manual_seed(1)
        sk = s2.PrivateKey.create(params, g, device=dev)
        say(f"Params(k={k}): n={params.n} m={params.m} r={params.r} L={params.num_limbs} "
            f"Q~2^{params.Q.bit_length()} [{time.time() - t0:.1f}s]")

        t0 = time.time()
        bkey = s2.BootstrapKey.create(ctx, sk, g)
        sync(dev)
        keygen_s = time.time() - t0
        say(f"BootstrapKey (chunked, real): {bkey.hat.numel() * 8 / 2**30:.1f} GiB hat+shoup "
            f"[{keygen_s:.1f}s]")

        m1 = params.m // M2
        mesh = mesh_mod.make_mesh(dp=1, tp=distributed.process_count())
        group = mesh.get_group("tp")
        t0 = time.time()
        rplan = rd.build_rotation_plan(params.moduli, m1, M2, dev)
        hat_d = rd.bkey_to_dist(ctx, rplan, bkey.hat, prune,
                                part=(dist.get_rank(group), dist.get_world_size(group)))
        sync(dev)
        convert_s = time.time() - t0
        say(f"bkey_to_dist (m1={m1}, m2={M2}, this rank's {hat_d.shape[-2]} rows): "
            f"[{convert_s:.1f}s]")

        rng = np.random.default_rng(7)
        x = rng.integers(0, 2**k, params.n)
        y = rng.integers(0, 2**k, params.n)
        lx = bs2.split_ciphertext(params, *s2.encrypt(sk, g, torch.as_tensor(x)))
        ly = bs2.split_ciphertext(params, *s2.encrypt(sk, g, torch.as_tensor(y)))
        idx = np.arange(batch) % params.n
        ti = torch.as_tensor(idx, device=lx.a.device)
        lx = LWE(lx.a[ti], lx.b[ti])
        ly = LWE(ly.a[ti], ly.b[ti])

        t0 = time.time()
        digit, carry = rd.add_with_carry_dist(params, ctx, rplan, mesh, hat_d, lx, ly,
                                              prune=prune)
        sync(dev)
        add_s = time.time() - t0
        say(f"add_with_carry_dist batch {batch}: [{add_s:.1f}s]")

        z = torch.as_tensor(x[idx] + y[idx], device=digit.b.device)
        K = 2**k
        if not (torch.equal(bs2.decrypt_lwe(sk, digit), z % K)
                and torch.equal(bs2.decrypt_lwe(sk, carry), z // K)):
            raise SystemExit(f"FAIL: digit/carry mismatch: {bs2.decrypt_lwe(sk, digit)} + "
                             f"{bs2.decrypt_lwe(sk, carry)} vs {z}")
        noise = int(bs2.lwe_phase_noise(sk, digit, z % K).abs().max())
        say(f"PASS k={k} dist (tp={distributed.process_count()}, prune={prune}): digit+carry "
            f"decrypt-verified on {batch} adds; max |noise| {noise} vs boundary Dr/2 = "
            f"{params.Dr // 2}")
        return dict(params=params, ctx=ctx, sk=sk, bkey=bkey, rplan=rplan, mesh=mesh,
                    key_dist=hat_d, lx=lx, ly=ly, digit=digit, carry=carry, z=z,
                    noise=noise, keygen_s=keygen_s, convert_s=convert_s, add_s=add_s)
    finally:
        if joined:
            dist.destroy_process_group()


if __name__ == "__main__":
    main()
