"""Timing and tracing (counterpart of sgfhe_tpu/utils/profiling.py).

- `timeit(fn, *args)`  wall-clock seconds a call, after warm-up calls, with
                       `torch.cuda.synchronize()` fencing when work ran on
                       the card.
- `trace(path)`        context manager around `torch.profiler`: writes a
                       Chrome trace (view it in Perfetto or chrome://tracing)
                       under `path`.
- `span(name)`        one of the program's own spans, at a layer boundary:
                       while a `torch.profiler` profile records in the
                       process (`trace`, or any `torch.profiler.profile`), a
                       `record_function("sgfhe:<name>")` range in the
                       profiler's trace and a (name, start, end) entry in
                       the record; otherwise a check of the profiler's flag.
- `spans()`            the record: the spans that ended since `trace()` last
                       began.
- `on_trace_clock(record, t)` the record's spans in the seconds of an
                       exported Chrome trace of the same window.

The program's spans, from the entry points down: `gates`
(models/bootstrap.bootstrap_batch), `digits` (models/bootstrap2.
add_with_carry) and `circuit` (circuit.evaluate_internal) around a call;
`circuit.level` one level of a circuit (gather, pad, bootstrap, switch,
scatter); `bootstrap` one batched rotation with its test vectors and
extraction (models/bootstrap.bootstrap_internal, models/bootstrap2.
_rotate_extract); `rotate` the blind rotation (models/bootstrap.
blind_rotate); `switch` one exact Q->r switch (ops/rns.rescale_exact). In
Perfetto the `sgfhe:` ranges sit on the host's thread above the card's
kernels, on one clock.

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
from collections import deque

import torch
from torch.profiler import record_function

#: Most spans the record holds; past it the oldest are dropped.
RECORD_CAP = 1 << 16
#: libkineto puts an exported trace's zero (its `baseTimeNanoseconds`) on a
#: whole multiple of this many seconds of the Unix clock (its
#: ChromeTraceBaseTime; torch.profiler's `_trimester_base_ns`).
TRACE_BASE_PERIOD_S = 7_889_238

_enabled = torch.autograd._profiler_enabled
#: (name, start_ns, end_ns) of each span, `time.time_ns()` readings, in the
#: order the spans ended
_RECORD: deque = deque(maxlen=RECORD_CAP)


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
    is available), with the program's `sgfhe:` spans; `spans()` holds the
    window's record afterwards."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(path, exist_ok=True)
    _RECORD.clear()
    with profile(activities=activities) as prof:
        yield prof
        _fence()
    n = len(os.listdir(path))
    prof.export_chrome_trace(os.path.join(path, f"trace-{os.getpid()}-{n}.json"))


class span:
    """`with span("rotate"):` records one of the program's spans (module
    docstring) while a profile records. The profiler's flag is read when
    the span is made; off, the span is one shared inert context: no range,
    no clock read, no entry."""

    __slots__ = ("name", "_range", "_start_ns")

    def __new__(cls, name: str):
        if not _enabled():
            return _OFF
        self = object.__new__(cls)
        self.name = name
        return self

    def __enter__(self) -> None:
        self._range = record_function("sgfhe:" + self.name)
        self._start_ns = time.time_ns()
        self._range.__enter__()

    def __exit__(self, *exc) -> None:
        self._range.__exit__(*exc)
        _RECORD.append((self.name, self._start_ns, time.time_ns()))


_OFF = contextlib.nullcontext()


def spans() -> list[tuple[str, int, int]]:
    """The record: (name, start_ns, end_ns) of every span that ended since
    `trace()` last began (at most RECORD_CAP, the newest), in the order
    they ended. Reading it leaves it as it is. Only `trace()` starts it
    anew: windows of a `torch.profiler.profile` opened directly (or the
    cycles of its `schedule`) add to it."""
    return list(_RECORD)


def on_trace_clock(record, t_in_window_s: float) -> list[tuple[float, float]]:
    """(start, end) of each span of `record` in seconds on the clock of a
    Chrome trace that torch.profiler exported from the same window
    (`export_chrome_trace`: an event's `ts` is microseconds after the
    trace's `baseTimeNanoseconds`), given any time of that window in the
    trace's seconds, t_in_window_s. The trace's zero is the whole multiple
    of TRACE_BASE_PERIOD_S nearest to the first span's start less
    t_in_window_s. So a span lies, in a viewer such as Perfetto, where its
    `sgfhe:` range does, within microseconds."""
    if not record:
        return []
    period = TRACE_BASE_PERIOD_S * 10**9
    base = round((record[0][1] - t_in_window_s * 1e9) / period) * period
    return [((s - base) / 1e9, (e - base) / 1e9) for _, s, e in record]
