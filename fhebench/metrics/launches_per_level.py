"""launches_per_level.<cells>: kernel launches the host made in the
profiled calls (the profiler's runtime launch events) a gate batch (a
circuit level)."""

#: The spans this reader reads: (module, attribute, span), for hooks.py.
SPANS = (
    ("sgfhe_tpu_torch.models.bootstrap", "bootstrap_internal", "bootstrap_internal"),
)


def read(run, variant: str):
    t = run.trace
    levels = t.span_count("bootstrap_internal") if t is not None else 0
    if not levels or not t.device_ops:
        return None
    return t.launches_in("call") / levels
