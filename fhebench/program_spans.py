"""The port's own spans on a traced run's timeline.

The port records a span at each layer boundary while a profile records
(sgfhe_tpu_torch.utils.profiling: `spans()`, the record of the profiled
window, and `on_trace_clock`, which maps it onto an exported trace's
seconds). This module maps the traced run's record onto `run.trace` and
reads it with the trace's own rules, on a copy of the trace whose spans
are the port's: the window's idle device time put to the innermost span
the host was in when each gap began (chrome_trace.Trace.idle_gaps_by_span),
and the kernel launches the host made inside the spans of one name
(Trace.launches_in).

Each returns None where there is nothing to read: no traced window, no
device operations, a port that records no spans of its own (no `spans`
in its profiling module), an empty record, or a span that lies outside
the window (a mapping that went wrong).
"""

from __future__ import annotations

import copy

from fhebench.chrome_trace import SPAN


def mapped(run):
    """[(start, end, name)] of the record's spans in the trace's seconds, or
    None (module docstring)."""
    t = run.trace
    if t is None or not t.window:
        return None
    from sgfhe_tpu_torch.utils import profiling

    spans = getattr(profiling, "spans", None)
    on_trace_clock = getattr(profiling, "on_trace_clock", None)
    if spans is None or on_trace_clock is None:
        return None
    record = spans()
    if not record:
        return None
    w0, w1 = t.window
    out = []
    for (name, _, _), (s, e) in zip(record, on_trace_clock(record, w0)):
        if s < w0 or e > w1:
            return None
        out.append((s, e, name))
    return out


def _port_trace(run):
    """A shallow copy of run.trace whose spans are the port's, or None."""
    spans = mapped(run)
    if spans is None or not run.trace.device_ops:
        return None
    t = copy.copy(run.trace)
    t.spans = {}
    for s, e, name in spans:
        t.spans.setdefault(SPAN + name, []).append((s, e))
    return t


def idle_seconds_in(run, name: str):
    """Seconds of the traced window in which the device was idle, over the
    gaps that began with the host innermost in a span `name`."""
    t = _port_trace(run)
    return None if t is None else dict(t.idle_gaps_by_span(top=None)).get(name, 0.0)


def count(run, name: str):
    """Spans `name` in the record."""
    t = _port_trace(run)
    return None if t is None else t.span_count(name)


def launches_in(run, name: str):
    """Kernel launches (the trace's runtime launch events) the host made
    inside the spans `name`."""
    t = _port_trace(run)
    return None if t is None else t.launches_in(name)
