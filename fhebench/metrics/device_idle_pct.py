"""device_idle_pct.<cells>: the share of the profiled calls' wall time in
which no device operation ran, from the profiler's timeline. The variant
names the end-to-end metric it moves; the quantity is the same."""


def read(run, variant: str):
    t = run.trace
    if t is None or not t.device_ops or t.window_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
