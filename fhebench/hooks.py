"""Spans around the entries of sgfhe_tpu_torch's layers, and the count of
every blind rotation with the shapes it receives.

The port records no spans of its own yet, so this module wraps each entry
by name, as chip_smoke.py's `CountRotations` wraps `blind_rotate`, in a
`torch.profiler.record_function` range named "fhebench:<span>". Callers
reach each of these names through its module at call time
(models/bootstrap2 binds `blind_rotate` at import, so it is wrapped there
too). A name that is gone stops the run, naming this wrapper. A later
change that records spans inside the program replaces this module.

The spans wrapped are BREAKDOWN's, which the traced run's breakdown puts
its idle gaps to, and those that the cell's metric readers declare in a
`SPANS` tuple of their own (metrics/<family>.py), so that a metric of a
new layer brings its spans with it. Every rotation is counted in every
watched request, traced or not, from the tensors `blind_rotate` receives.
"""

from __future__ import annotations

import contextlib
import functools
import importlib
import inspect

#: The rotation's entries, counted in every watched request.
ROTATE = (
    ("sgfhe_tpu_torch.models.bootstrap", "blind_rotate", "blind_rotate"),
    ("sgfhe_tpu_torch.models.bootstrap2", "blind_rotate", "blind_rotate"),
)
#: (module, attribute, span) of each layer's entry, from the entry points
#: down: the spans of every traced run.
BREAKDOWN = (
    ("sgfhe_tpu_torch.circuit", "evaluate", "circuit.evaluate"),
    ("sgfhe_tpu_torch.models.bootstrap", "bootstrap_batch", "bootstrap_batch"),
    ("sgfhe_tpu_torch.models.bootstrap2", "add_with_carry", "add_with_carry"),
    ("sgfhe_tpu_torch.models.bootstrap", "bootstrap_internal", "bootstrap_internal"),
    ("sgfhe_tpu_torch.models.bootstrap2", "_rotate_extract", "rotate_extract"),
    ("sgfhe_tpu_torch.models.bootstrap", "_reduce_lwe", "reduce_lwe"),
    ("sgfhe_tpu_torch.ops.rns", "rescale_exact", "rescale_exact"),
) + ROTATE


def rotation_shape(sig, args, kwargs) -> dict:
    """What one blind_rotate call receives, as cost.least_seconds takes it:
    B lanes and n steps from the exponents (B, n), L limbs and the ring's
    m from the accumulators (B, L, m), the key's l digits from its rows
    (n, 2 l, 2, L, m), and lk = l - prune of them kept."""
    bound = sig.bind(*args, **kwargs)
    bound.apply_defaults()
    a = bound.arguments
    B, n = a["ua"].shape
    _, L, m = a["a_acc"].shape
    l = int(a["bkey_hat"].shape[1]) // 2
    return dict(B=int(B), n=int(n), L=int(L), m=int(m), l=l, lk=l - int(a["prune"]),
                randomized=a["seed2"] is not None)


@contextlib.contextmanager
def installed(spans=()):
    """Count every rotation, and wrap BREAKDOWN's entries and `spans` (more
    (module, attribute, span) triples) in record_function ranges, while
    open; yields the list that collects each rotation's shape. With
    spans=None no range is recorded: the rotations are counted alone."""
    from torch.profiler import record_function

    rotations: list[dict] = []
    wanted = {}
    for mod_name, attr, span in ROTATE + (() if spans is None else BREAKDOWN + tuple(spans)):
        wanted.setdefault((mod_name, attr), None if spans is None else span)
    saved = []
    try:
        for (mod_name, attr), span in wanted.items():
            mod = importlib.import_module(mod_name)
            orig = getattr(mod, attr, None)
            if orig is None:
                raise RuntimeError(f"fhebench/hooks.py wraps {mod_name}.{attr}, which is "
                                   f"gone: the wrapper needs the layer's new entry")
            sig = inspect.signature(orig) if (mod_name, attr, "blind_rotate") in ROTATE else None
            name = None if span is None else "fhebench:" + span

            def wrapper(*args, __orig=orig, __name=name, __sig=sig, **kwargs):
                if __sig is not None:
                    rotations.append(rotation_shape(__sig, args, kwargs))
                if __name is None:
                    return __orig(*args, **kwargs)
                with record_function(__name):
                    return __orig(*args, **kwargs)

            saved.append((mod, attr, orig))
            setattr(mod, attr, functools.wraps(orig)(wrapper))
        yield rotations
    finally:
        for mod, attr, orig in reversed(saved):
            setattr(mod, attr, orig)
