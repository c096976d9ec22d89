"""setup_s: seconds from the start of the process to the first timed call:
imports, the kernels' build (served from the checkout's build/ after the
first run), keys, inputs and one warm call of each of the cell's shapes."""


def read(run, variant: str):
    return run.setup_s
