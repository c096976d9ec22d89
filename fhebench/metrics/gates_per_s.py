"""gates_per_s: gate bootstraps whose answers reached the host in the
window, over the window's seconds (one bootstrap, AND, OR and XOR of a
pair, counts as one gate)."""


def read(run, variant: str):
    gates = run.work.get("gates")
    return gates / run.window_s if gates and run.window_s > 0 else None
