"""rotate_host_ms.<cells>: host milliseconds inside `blind_rotate` a gate
batch (a circuit level: one `bootstrap_internal` span each)."""

#: The spans this reader reads: (module, attribute, span), for hooks.py.
SPANS = (
    ("sgfhe_tpu_torch.models.bootstrap", "blind_rotate", "blind_rotate"),
    ("sgfhe_tpu_torch.models.bootstrap2", "blind_rotate", "blind_rotate"),
    ("sgfhe_tpu_torch.models.bootstrap", "bootstrap_internal", "bootstrap_internal"),
)


def read(run, variant: str):
    t = run.trace
    levels = t.span_count("bootstrap_internal") if t is not None else 0
    return t.span_seconds("blind_rotate") * 1e3 / levels if levels else None
