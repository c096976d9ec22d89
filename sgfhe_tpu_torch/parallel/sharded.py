"""Sharded bootstrap and packing over a ('dp', 'tp') mesh (counterpart of
sgfhe_tpu/parallel/sharded.py), on `torch.distributed`.

Every rank is given the whole batch and the whole key (replicated),
computes its own slice of the batch (parallel/mesh.batch_sharding, dp and
tp as one data axis) and all-gathers the slices, so that each rank
returns the whole result, as the JAX functions return a global array:

 - `bootstrap_batch_sharded`: gates shard over the mesh; each rank's slice
   goes through models/bootstrap.bootstrap_internal, so on the card the
   CUDA rotation kernels run it. No collective in the rotation loop.
 - `pack_encrypted_bits_sharded`: the n trivial-input bootstraps shard as
   a gate batch, and the n-term shortened-external-product reduction
   (reference src/fhe.jl:683-687) becomes a sum over the mesh of each
   rank's partial, tensor parallelism over the key-index axis. The JAX
   package gathers the partials and sums them modulo p; here the int64
   partials (each < p < 2^30) are summed by one all_reduce and reduced by
   one remainder, the same output.
 - `scheme2_encrypt_batch_sharded` / `scheme2_decrypt_batch_sharded`:
   scheme-2 message blocks shard over the mesh.

Collectives move int64 tensors only.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from ..models import bootstrap as bs
from ..models import scheme2 as s2
from ..models.params import Params
from ..models.scheme1 import LWE, Ciphertext, SchemeContext
from . import mesh as mesh_mod


def _pad_to(tensors, multiple: int):
    """Zero-pad the leading (gate) axis up to a multiple; returns (padded,
    original length)."""
    B = tensors[0].shape[0]
    padded = -(-B // multiple) * multiple
    if padded == B:
        return list(tensors), B
    return [torch.cat([t, t.new_zeros((padded - B,) + t.shape[1:])]) for t in tensors], B


def _gather(group, count: int, x: torch.Tensor) -> torch.Tensor:
    """Every rank's x (equal shapes) concatenated along the leading axis in
    group-rank order."""
    x = x.contiguous()
    out = x.new_empty((count * x.shape[0],) + x.shape[1:])
    dist.all_gather_into_tensor(out, x, group=group)
    return out


def bootstrap_batch_sharded(params: Params, ctx: SchemeContext, bkey, lwe1: LWE,
                            lwe2: LWE, mesh):
    """The gate batch sharded over every rank of the mesh ('dp' and 'tp'
    both act as data axes here), key and context replicated, deterministic
    mode. Any batch size works: the batch is zero-padded up to the mesh
    size and trimmed on return. Returns (AND, OR, XOR) LWE batches mod r,
    whole on every rank."""
    group, _, count = mesh_mod.mesh_slot(mesh)
    (a1, b1, a2, b2), B = _pad_to([lwe1.a, lwe1.b, lwe2.a, lwe2.b], count)
    a1, b1, a2, b2 = (mesh_mod.batch_sharding(mesh, t) for t in (a1, b1, a2, b2))
    res = bs.bootstrap_internal(params, ctx, bkey.hat, bkey.hat_shoup, a1, b1, a2, b2)
    out = []
    for t in res:
        lw = bs._reduce_lwe(params, ctx, t)
        out.append(LWE(_gather(group, count, lw.a)[:B], _gather(group, count, lw.b)[:B]))
    return tuple(out)


def pack_encrypted_bits_sharded(params: Params, ctx: SchemeContext, bkey,
                                enc_bits: LWE, mesh) -> Ciphertext:
    """Distributed repack (models/bootstrap.pack_encrypted_bits in
    deterministic mode, through its pack_internal): the bootstraps shard
    over the mesh as gates, and the key-index reduction is a sum over the
    mesh. The mesh size must divide n. Returns the Ciphertext on every
    rank."""
    n = params.n
    group, index, count = mesh_mod.mesh_slot(mesh)
    assert n % count == 0, f"pack: the mesh size {count} must divide n = {n}"
    shard = n // count
    p = ctx.plan_Q.p

    def reduce(parts):
        # count partials below 2^30 each: the int64 sum is exact
        dist.all_reduce(parts, group=group)
        return torch.remainder(parts, p)

    rlwe = bs.pack_internal(params, ctx, bkey.hat, bkey.hat_shoup, enc_bits,
                            keys=slice(index * shard, (index + 1) * shard),
                            gather=lambda x: _gather(group, count, x), reduce=reduce)
    return Ciphertext(params, rlwe)


# ---------------------------------------------------------------------------
# Scheme-2 sharded batch encryption and decryption (message blocks shard
# over every mesh axis)
# ---------------------------------------------------------------------------


def scheme2_encrypt_batch_sharded(sk2, seeds, messages, mesh):
    """Private-key encryption of a batch of scheme-2 message blocks,
    sharded. seeds: B ints, block i drawn from torch.Generator seeded with
    seeds[i] (the port's randomness API); messages: (B, n) ints in
    [0, 2^k). Returns (a, b), each (B, n), on every rank; any B works."""
    group, _, count = mesh_mod.mesh_slot(mesh)
    dev = sk2.key.device
    messages = torch.as_tensor(messages, device=dev).to(torch.int64)
    seeds = torch.as_tensor([int(s) for s in seeds], dtype=torch.int64)
    B = messages.shape[0]
    (msgs, seeds), _ = _pad_to([messages, seeds], count)
    seeds[B:] = seeds[0]  # padding blocks repeat the first seed, as the JAX package's
    outs = [s2._encrypt_private(sk2, torch.Generator().manual_seed(int(s)), msg)
            for s, msg in zip(mesh_mod.batch_sharding(mesh, seeds),
                              mesh_mod.batch_sharding(mesh, msgs))]
    a = torch.stack([o[0] for o in outs])
    b = torch.stack([o[1] for o in outs])
    return _gather(group, count, a)[:B], _gather(group, count, b)[:B]


def scheme2_decrypt_batch_sharded(sk2, a, b, mesh):
    """Decrypt a batch of scheme-2 ciphertexts ((B, n) each), sharded ->
    (B, n) digits on every rank."""
    group, _, count = mesh_mod.mesh_slot(mesh)
    (a, b), B = _pad_to([a, b], count)
    digits = s2.decrypt(sk2, mesh_mod.batch_sharding(mesh, a), mesh_mod.batch_sharding(mesh, b))
    return _gather(group, count, digits)[:B]
