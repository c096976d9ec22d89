"""rotate_idle_pct.<cells>: the share of the traced window in which the
device idled with the host innermost in the port's `rotate` span (the
blind rotation, models/bootstrap.blind_rotate: the step pair's host loop
or one launch), from the port's own record (program_spans.py)."""

from fhebench import program_spans


def read(run, variant: str):
    idle = program_spans.idle_seconds_in(run, "rotate")
    return None if idle is None else 100.0 * idle / run.trace.window_s
