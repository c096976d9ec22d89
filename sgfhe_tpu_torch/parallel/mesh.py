"""Device meshes for multi-card and multi-process runs (counterpart of
sgfhe_tpu/parallel/mesh.py), on `torch.distributed`.

A mesh is a `torch.distributed.device_mesh.DeviceMesh` of shape (dp, tp)
over the default group's ranks, one rank a card (or a CPU process under
gloo), with the JAX package's axes:

 - 'dp': data parallelism over the batch of gates;
 - 'tp': tensor parallelism over the bootstrap-key index axis of
   `pack_encrypted_bits_sharded`, and the transform axis of the
   distributed four-step NTT (parallel/ntt_dist.py, rotate_dist.py).

torch has no `NamedSharding`: a tensor is not laid out over a mesh by a
sharding object, and a collective names a process group. So every rank
holds the whole batch it was given and computes on its own slice of it:
`batch_sharding(mesh, x)` returns the rank's slice of the leading axis,
with dp and tp taken together as one data axis (the JAX package's
P(("dp", "tp"))), a replicated tensor (P()) is x itself on every rank, and
`mesh_group` is the process group over the whole mesh that gathers the
slices back. The mesh's device type follows the default group's backend:
cuda under nccl, cpu under gloo.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh


def _device_type() -> str:
    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def make_mesh(dp: int | None = None, tp: int = 1) -> DeviceMesh:
    """The (dp, tp) mesh over the first dp*tp ranks of the default group
    (every rank calls it: building the mesh's groups is collective)."""
    if not dist.is_initialized():
        raise RuntimeError("no process group: call parallel.distributed.initialize first")
    n = dist.get_world_size()
    if dp is None:
        dp = n // tp
    assert dp * tp <= n, f"mesh {dp}x{tp} needs {dp*tp} devices, have {n}"
    ranks = torch.arange(dp * tp, dtype=torch.int).reshape(dp, tp)
    return DeviceMesh(_device_type(), ranks, mesh_dim_names=("dp", "tp"))


def mesh_group(mesh: DeviceMesh):
    """The process group over every rank of the mesh: the default group
    when the mesh spans the world, else the group of its one axis longer
    than 1 (a smaller mesh with both axes longer than 1 is refused). Only
    the mesh's ranks may call it."""
    assert mesh.get_coordinate() is not None, f"rank {dist.get_rank()} is not in the mesh"
    dp, tp = mesh.shape
    if dp * tp == dist.get_world_size():
        return dist.group.WORLD
    if dp > 1 and tp > 1:
        raise ValueError(f"a {dp}x{tp} mesh over part of a world of "
                         f"{dist.get_world_size()} has no group of all its ranks")
    return mesh.get_group("dp" if tp == 1 else "tp")


def mesh_slot(mesh: DeviceMesh) -> tuple:
    """(group, index, count): the mesh's process group, this rank's index in
    it and the mesh's size. Slice `index` of a batch cut in `count` equal
    slices is this rank's, and `all_gather_into_tensor` over the group puts
    slice i at position i."""
    group = mesh_group(mesh)
    return group, dist.get_rank(group), dist.get_world_size(group)


def batch_sharding(mesh: DeviceMesh, x: torch.Tensor) -> torch.Tensor:
    """This rank's slice of x's leading (gate) axis over dp and tp taken
    together; the axis must divide evenly (sharded._pad_to pads it)."""
    _, index, count = mesh_slot(mesh)
    assert x.shape[0] % count == 0, (x.shape[0], count)
    per = x.shape[0] // count
    return x[index * per:(index + 1) * per]
