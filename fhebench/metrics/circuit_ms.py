"""circuit_ms: the window's milliseconds over the circuits it completed, one
client in a closed loop."""


def read(run, variant: str):
    circuits = run.work.get("circuits")
    return run.window_s * 1e3 / circuits if circuits else None
