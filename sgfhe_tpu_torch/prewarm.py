"""Cold-start priming (counterpart of sgfhe_tpu/prewarm.py).

On the card, the first bootstrap of a process pays for building the
rotation kernels (`nvcc` on csrc/rotate.cu and csrc/rotate_resident.cu, in
parallel, seconds) and the wire codec (`g++` on csrc/sgfhe_io.cpp), the
context's tables, and the first launch of each launch plan. `prewarm(params)`
does all of that before real keys or data exist: it builds every library,
makes the context and runs one batch of all-zero stand-ins through the
production path (models/bootstrap.bootstrap_batch, on the route that
params' key takes: the one-launch rotate_resident for a key of at most 10
MiB, the step pair above that) in each requested mode. Values do not
matter to any of these costs, so the key is all zeros and costs nothing to
make. Stages narrate to stderr (utils/progress; SGFHE_PROGRESS=0 or
verbose=False silences them).

Usage:  python -c "import sgfhe_tpu_torch as T; T.prewarm(T.Params.create(512))"
or from code before a service takes traffic. It runs on the card unless it
is given device="cpu" (there it builds the codec only: the CPU runs the
kernels' plain versions). A build that fails raises.
"""

from __future__ import annotations

import time

import torch

from .utils import progress

SEED_WORDS = (0, 0)  # stand-in seed words of the randomized mode


def prewarm(
    params,
    ctx=None,
    batch: int | None = None,
    modes: tuple[str, ...] = ("deterministic", "randomized"),
    verbose: bool = True,
    device=None,
) -> dict:
    """Build, make the context and run each mode once for `params`. Returns
    per-stage seconds: "context" (the builds and the context's tables) and
    one entry per mode.

    batch: the production batch size (the launch plans follow it, so warm
    with the size you will run; defaults to 8192 for n = 64, 64 for
    n = 512, 16 for n = 1024 and up, as the JAX package's).
    """
    from . import _build, native
    from .models import bootstrap as bs
    from .models.scheme1 import LWE, make_context, resolve_device

    if verbose:
        progress.enable(True)
    dev = resolve_device(device)
    n, m = params.n, params.m
    l, L = params.num_digits, params.num_limbs
    if batch is None:
        batch = 8192 if n <= 64 else (64 if n <= 512 else 16)
    timings: dict[str, float] = {}

    t0 = time.time()
    if dev.type == "cuda":
        with progress.stage(f"build csrc/{', csrc/'.join(_build.SOURCES)} (nvcc, sm_90a)"):
            for source in _build.SOURCES:
                _build.load(source)
    with progress.stage("build csrc/sgfhe_io.cpp (g++)"):
        native.load()
    if ctx is None:
        where = "the card" if dev.type == "cuda" else "the host CPU"
        with progress.stage(f"make_context n={n} (tables for m={m}, L={L}) on {where}"):
            ctx = make_context(params, device=dev)
    timings["context"] = time.time() - t0

    # all-zero stand-ins: the builds and plans depend on shapes only
    bkey_hat = torch.zeros((n, 2 * l, 2, L, m), dtype=torch.int32, device=dev)
    lwe = LWE(torch.zeros((batch, n), dtype=torch.int64, device=dev),
              torch.zeros((batch,), dtype=torch.int64, device=dev))
    for mode in modes:
        seed = SEED_WORDS if mode == "randomized" else None
        what = ("first launch of each plan on the card" if dev.type == "cuda"
                else "the plain kernels on the host CPU")
        with progress.stage(f"first run of bootstrap n={n} batch={batch} {mode} ({what})") as st:
            out = bs.bootstrap_batch(params, ctx, bkey_hat, bkey_hat, lwe, lwe, seed)
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
        del out
        timings[mode] = time.time() - st.t
    progress.log(
        f"prewarm(n={n}) complete "
        f"({', '.join(f'{k}={v:.1f}s' for k, v in timings.items())})"
    )
    return timings
