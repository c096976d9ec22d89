"""switch_launches.<cells>: kernel launches the host made inside the port's
`switch` spans (the exact Q->r switch) a `bootstrap` span (a gate batch, a
circuit level), from the port's own record (program_spans.py)."""

from fhebench import program_spans


def read(run, variant: str):
    launches = program_spans.launches_in(run, "switch")
    batches = program_spans.count(run, "bootstrap")
    return launches / batches if launches is not None and batches else None
