"""switch_host_ms.<cells>: host milliseconds inside `_reduce_lwe`, the Q->r
switch of a gate batch's three answers, a gate batch (a circuit level)."""

#: The spans this reader reads: (module, attribute, span), for hooks.py.
SPANS = (
    ("sgfhe_tpu_torch.models.bootstrap", "_reduce_lwe", "reduce_lwe"),
    ("sgfhe_tpu_torch.models.bootstrap", "bootstrap_internal", "bootstrap_internal"),
)


def read(run, variant: str):
    t = run.trace
    levels = t.span_count("bootstrap_internal") if t is not None else 0
    return t.span_seconds("reduce_lwe") * 1e3 / levels if levels else None
