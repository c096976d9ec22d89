"""Multi-process runtime: joining the process group, host-aware meshes,
and the scaling-efficiency harness (counterpart of
sgfhe_tpu/parallel/distributed.py), on `torch.distributed`.

One process a card. `initialize` joins the group: NCCL when the device is
"cuda" (each rank bound to its card), gloo on the CPU. There is no
fallback: a failed NCCL start raises. On one H100 the layer runs at world
size 1 over NCCL (two ranks cannot share one card under NCCL); the CPU
tests run gloo ranks as separate processes, and `torchrun
--nproc-per-node 2 -m sgfhe_tpu_torch.examples.scaling ... --device cpu`
starts such a world by hand.

`make_global_mesh` lays the ranks out host-major, as the JAX package
does: a 'tp' group never crosses a host, so its all_to_all traffic stays
on the host's links, and 'dp' spans hosts.
"""

from __future__ import annotations

import os
import socket
import time

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from ..models.scheme1 import resolve_device
from . import mesh as mesh_mod


def initialize(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    local_device_ids=None,
    *,
    device=None,
) -> None:
    """Join the process group (`init_process_group`).

    coordinator_address "host:port" becomes init_method "tcp://host:port";
    an address with a scheme ("file:///path") is passed as it is. Without
    it the group forms from the environment (env://: MASTER_ADDR,
    MASTER_PORT, RANK, WORLD_SIZE, as torchrun sets them). device: "cuda"
    unless the caller names another; the backend is nccl on cuda and gloo
    otherwise. On cuda the rank is bound to its card: local_device_ids[0],
    else LOCAL_RANK, else process_id modulo the card count."""
    dev = resolve_device(device)
    kwargs = {"backend": "nccl" if dev.type == "cuda" else "gloo"}
    if coordinator_address is None:
        kwargs["init_method"] = "env://"
    elif "://" in coordinator_address:
        kwargs["init_method"] = coordinator_address
    else:
        kwargs["init_method"] = "tcp://" + coordinator_address
    if num_processes is not None:
        kwargs["world_size"] = num_processes
    if process_id is not None:
        kwargs["rank"] = process_id
    if dev.type == "cuda":
        if local_device_ids:
            local = int(local_device_ids[0])
        elif "LOCAL_RANK" in os.environ:
            local = int(os.environ["LOCAL_RANK"])
        else:
            local = (process_id or 0) % torch.cuda.device_count()
        torch.cuda.set_device(local)
        # a bound device makes NCCL start now, so a card that cannot join fails here
        kwargs["device_id"] = torch.device("cuda", local)
    dist.init_process_group(**kwargs)


def init_world(device=None) -> bool:
    """Make sure a process group exists: the one already joined, else the
    torchrun world the environment names (WORLD_SIZE), else a world of this
    process alone on a free local port. Returns True when it joined one
    (the caller then destroys it)."""
    if dist.is_initialized():
        return False
    if "WORLD_SIZE" in os.environ:
        initialize(device=device)
        return True
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    initialize(f"localhost:{port}", 1, 0, device=device)
    return True


def make_global_mesh(tp: int = 1) -> DeviceMesh:
    """('dp', 'tp') mesh over every rank, host-major.

    Ranks are ordered by (host, rank) and reshaped (dp, tp) with tp
    innermost, so a tp group never crosses a host boundary (tp must divide
    every host's rank count)."""
    world = dist.get_world_size()
    hosts = [None] * world
    dist.all_gather_object(hosts, socket.gethostname())
    first = {}
    for r, h in enumerate(hosts):
        first.setdefault(h, r)
    order = sorted(range(world), key=lambda r: (first[hosts[r]], r))
    local_counts = {h: hosts.count(h) for h in first}
    min_local = min(local_counts.values())
    assert tp <= min_local and min_local % tp == 0, (
        f"tp={tp} must divide the per-host device count {min_local} "
        f"(a tp group must not cross hosts)"
    )
    ranks = torch.tensor(order, dtype=torch.int).reshape(world // tp, tp)
    return DeviceMesh(mesh_mod._device_type(), ranks, mesh_dim_names=("dp", "tp"))


def process_count() -> int:
    """The world size (1 without a process group)."""
    return dist.get_world_size() if dist.is_initialized() else 1


def scaling_report(params, ctx, bkey, lwe1, lwe2, device_counts=None,
                   iters: int = 3, out=None):
    """Bootstrap gates/s on meshes of each of `device_counts` ranks
    (default: the whole world) and the parallel efficiency: each row's
    per-rank rate against the first row's. Every rank calls it (building a
    row's mesh is collective); ranks outside a row's mesh skip its timing.
    Rank 0 prints the rows to `out`. Returns [(n_devices, gates_per_sec,
    efficiency)] of the rows this rank ran."""
    from . import sharded

    world = process_count()
    if device_counts is None:
        device_counts = [world]
    rows = []
    base = None       # per-rank rate of the FIRST row (any device count)
    base_nd = None
    batch = lwe1.a.shape[0]
    cuda = lwe1.a.device.type == "cuda"
    for nd in device_counts:
        mesh = mesh_mod.make_mesh(dp=nd, tp=1)
        if dist.get_rank() < nd:
            sharded.bootstrap_batch_sharded(params, ctx, bkey, lwe1, lwe2, mesh)  # warm
            if cuda:
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(iters):
                sharded.bootstrap_batch_sharded(params, ctx, bkey, lwe1, lwe2, mesh)
            if cuda:
                torch.cuda.synchronize()
            gps = batch * iters / (time.perf_counter() - t0)
            if base is None:
                base, base_nd = gps, nd
            eff = (gps / nd) / (base / base_nd)
            rows.append((nd, gps, eff))
            if out is not None and dist.get_rank() == 0:
                print(f"devices={nd}: {gps:.1f} gates/s, efficiency {eff*100:.0f}%",
                      file=out, flush=True)
    return rows
