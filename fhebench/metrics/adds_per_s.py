"""adds_per_s: digit pairs added with carry whose answers reached the host
in the window, over the window's seconds."""


def read(run, variant: str):
    adds = run.work.get("adds")
    return adds / run.window_s if adds and run.window_s > 0 else None
