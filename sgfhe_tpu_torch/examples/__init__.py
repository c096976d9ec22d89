"""The examples, the port's counterparts of the JAX package's examples/
scripts, with their positional arguments and defaults:

    python -m sgfhe_tpu_torch.examples.adder [nbits=8] [n=64] [instances=4]
    python -m sgfhe_tpu_torch.examples.depth [generations=100] [n=64] [prune=0]
    python -m sgfhe_tpu_torch.examples.errors [n=64] [trials=4]
    python -m sgfhe_tpu_torch.examples.scheme2_demo [k=1] [n=1024] [--bkey]
    python -m sgfhe_tpu_torch.examples.scheme2_add [k=1] [batch=64] [n=1024] [prune=0]
    python -m sgfhe_tpu_torch.examples.scaling [batch=256] [n=64]
    python -m sgfhe_tpu_torch.examples.scheme2_dist [k=4] [batch=2] [prune=0] [n=1024]

Each runs on the card, or on the CPU with `--device cpu`, checks its
results and raises SystemExit on a wrong one. The last two run on the
multi-device layer (parallel/) over the torch.distributed world: one rank
over NCCL on a card, or the ranks torchrun starts. Each `main(argv)` takes the
command-line words as a list, so that code can call it in-process.
"""

from __future__ import annotations

import sys


def parse(argv, defaults: tuple, flags: tuple = ()):
    """(positional values with `defaults` filled in, device, flags given)
    from the command-line words `argv` (sys.argv[1:] when None). Positional
    words are ints; `--device X` names the device (default "cuda")."""
    words = list(sys.argv[1:] if argv is None else argv)
    device, given, pos = "cuda", set(), []
    while words:
        w = words.pop(0)
        if w == "--device":
            device = words.pop(0)
        elif w.startswith("--device="):
            device = w.split("=", 1)[1]
        elif w in flags:
            given.add(w)
        elif w.startswith("--"):
            raise SystemExit(f"unknown option {w}")
        else:
            pos.append(int(w))
    if len(pos) > len(defaults):
        raise SystemExit(f"at most {len(defaults)} positional arguments, got {pos}")
    return tuple(pos) + tuple(defaults[len(pos):]), device, given


def sync(device) -> None:
    """Wait for the card's work (a no-op on the CPU)."""
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def describe(device) -> str:
    """The device's name, for the first line of an example's output."""
    import torch

    dev = torch.device(device)
    if dev.type == "cuda" and torch.cuda.is_available():
        return f"{dev} ({torch.cuda.get_device_name(dev)})"
    return str(dev)
