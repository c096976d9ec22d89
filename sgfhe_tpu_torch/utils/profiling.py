"""Timing and tracing (counterpart of sgfhe_tpu/utils/profiling.py).

- `timeit(fn, *args)`  wall-clock seconds a call, after warm-up calls, with
                       `torch.cuda.synchronize()` fencing when work ran on
                       the card.
- `trace(path)`        context manager around `torch.profiler`: writes a
                       Chrome trace (view it in Perfetto or chrome://tracing)
                       under `path`.
- `op_cost(params)`    the JAX package's analytic per-gate cost model of one
                       blind rotation, in Shoup-multiply equivalents (SME),
                       and the key bytes streamed: arithmetic on `Params`,
                       equal to the JAX function's output.

The JAX module's `measure_sme_rate` is not ported. It times a jitted chain
of Shoup multiplies on the TPU's vector unit; an eager PyTorch copy would
time the dispatch of each small op, not the card. The card's bound for
each rotation kernel is computed from its shapes in chip_smoke.py
(`bound`, `fwd_cost`, `mac_cost`) against the H100's published rates.
"""

from __future__ import annotations

import contextlib
import os
import time
from dataclasses import dataclass

import torch


def _fence() -> None:
    """Wait for the card's queued work, if any ran."""
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


def timeit(fn, *args, iters: int = 5, warmup: int = 1):
    """(seconds_per_call, last_result); fences device work each iteration."""
    out = None
    for _ in range(warmup):
        out = fn(*args)
    _fence()
    t0 = time.perf_counter()
    for _ in range(iters):
        out = fn(*args)
    _fence()
    return (time.perf_counter() - t0) / iters, out


@contextlib.contextmanager
def trace(path: str):
    """Capture a trace: `with trace('traces'): run()` writes
    traces/trace-<pid>-<n>.json (CPU ops, and the card's kernels when CUDA
    is available)."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(path, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
        _fence()
    n = len(os.listdir(path))
    prof.export_chrome_trace(os.path.join(path, f"trace-{os.getpid()}-{n}.json"))


# Op weights in Shoup-multiply equivalents, the JAX package's: one
# shoup_mul = mulhi (4 u16 multiplies + ~6 adds/shifts) + 2 low multiplies
# + subtract + select, about 15 elementary u32 vector ops; the others are
# scaled against that.
_W_SHOUP = 1.0
_W_MODU32 = 0.6     # mulhi + mul + 2 cond-subtracts
_W_ADDSEL = 0.15    # add/sub/compare/select


@dataclass(frozen=True)
class GateCost:
    sme_per_gate: float        # Shoup-multiply equivalents per gate (3 gates)
    ntt_transforms: int        # length-m limb-transforms per gate
    key_bytes: int             # bootstrap-key bytes (values + Shoup)
    acc_bytes: int             # accumulator working set per gate


def op_cost(params, prune: int = 0) -> GateCost:
    """Analytic per-gate cost of one bootstrap pass, the JAX package's model
    of its fused kernel: n steps of [flatten x2, fwd NTT on 2(l-prune) digit
    rows, gadget accumulation, monomial ladder, inv NTT on 2 columns].
    prune models the approximate-gadget fast mode (dropped rows cost no
    NTT/key-mul/embed work; the extraction chain still peels them)."""
    n, l, L, m = params.n, params.num_digits, params.num_limbs, params.m
    m1 = max(1, m // 128)
    S = m.bit_length() - 1
    maj = m1.bit_length() - 1          # butterfly stages (1 shoup / 2 elems)
    lane = S - maj                     # roll+select stages (1 shoup / elem)
    p_bits = max(params.moduli).bit_length()
    # lazy-reduction resets: bound doubles per stage, reset when 2*c*p > 2^32
    reset_every = max(1, 31 - p_bits)

    elems = L * m                      # one limb-spread polynomial
    # forward NTT per row: pre-twist + stages + periodic Barrett resets
    fwd_row = (
        elems * _W_SHOUP
        + maj * (elems / 2 * _W_SHOUP + elems * 2 * _W_ADDSEL)
        + lane * (elems * _W_SHOUP + elems * 3 * _W_ADDSEL)
        + (S / reset_every) * elems * _W_MODU32
    )
    inv_col = fwd_row  # same stage structure + post-twist ~ pre-twist
    # flatten (a and b): extraction chain on single-limb rows + re-embed
    lk = l - prune                     # kept digit rows per operand
    chain = sum(i for i in range(L)) * (m * (_W_SHOUP + _W_MODU32 + _W_ADDSEL))
    embed = lk * (elems * (_W_MODU32 + _W_ADDSEL))
    flatten2 = 2 * (chain + embed)
    # gadget accumulation: 2lk rows x 2 cols key muls + lk x 2 w-muls + adds
    accum = (2 * lk * 2 + lk * 2) * elems * (_W_SHOUP + _W_ADDSEL)
    # monomial ladder: log2(2m) shoup+select on 2 columns
    ladder = 2 * (2 * m).bit_length() * elems * (_W_SHOUP + 2 * _W_ADDSEL)

    per_step = flatten2 + 2 * lk * fwd_row + accum + ladder + 2 * inv_col
    return GateCost(
        sme_per_gate=n * per_step,
        ntt_transforms=n * (2 * lk + 2) * L,
        key_bytes=n * (2 * lk) * 2 * L * m * 4 * 2,
        acc_bytes=2 * L * m * 4,
    )
