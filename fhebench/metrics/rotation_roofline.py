"""rotation_roofline.<cells>: the profiled rotations' least time
(cost.least_seconds of each rotation's shape, as hooks.py counted them) over
the device time of the operations launched inside `blind_rotate`, in %."""

from fhebench import cost

#: The spans this reader reads: (module, attribute, span), for hooks.py.
SPANS = (
    ("sgfhe_tpu_torch.models.bootstrap", "blind_rotate", "blind_rotate"),
    ("sgfhe_tpu_torch.models.bootstrap2", "blind_rotate", "blind_rotate"),
)


def read(run, variant: str):
    t = run.trace
    if t is None or not run.rotations:
        return None
    device = t.device_seconds_launched_in("blind_rotate")
    if device <= 0:
        return None
    return 100.0 * sum(cost.least_seconds(**r) for r in run.rotations) / device
