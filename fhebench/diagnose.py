"""One cell's requests one by one, with what the host and the device did in
each: for finding why a cell's runs spread. The benchmark's runs never run
it.

    python3 fhebench/diagnose.py --workload <cell> --seed <n> --seconds <s> --trace-calls <k>

After the cell's set-up it serves requests for --seconds, untraced, and
prints one JSON line a request: its wall seconds and when it ended (the
host's epoch clock, to match a clock or power log such as nvidia-smi's),
its thread's CPU seconds, and before it the seconds of a fixed piece of
pure-Python work (the host's speed). Then it serves
--trace-calls requests under the profiler with the breakdown's spans and
prints for each the host seconds in each span, the device's busy seconds
and the host's kernel launches.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent


def _probe() -> float:
    """Seconds of a fixed piece of pure-Python work."""
    t = time.perf_counter()
    sum(i * i for i in range(100_000))
    return time.perf_counter() - t


def _untraced(drv, seconds: float) -> None:
    t0, i = time.perf_counter(), 0
    while time.perf_counter() - t0 < seconds:
        probe = _probe()
        req = drv.request(i)
        cpu0, w0 = time.thread_time(), time.perf_counter()
        drv.serve(req)
        w1, cpu1 = time.perf_counter(), time.thread_time()
        print(json.dumps({"request": i, "wall_s": w1 - w0, "ended": time.time(),
                          "probe_s": probe, "thread_cpu_s": cpu1 - cpu0}), flush=True)
        i += 1


def _traced(drv, calls: int) -> None:
    from torch.profiler import ProfilerActivity, profile, record_function

    from fhebench import chrome_trace, hooks

    with hooks.installed(), profile(
            activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for i in range(calls):
            with record_function(chrome_trace.CALL):
                drv.serve(drv.request(10_000 + i))
    fd, path = tempfile.mkstemp(prefix="fhebench-diagnose-", suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        t = chrome_trace.Trace.load(path)
    finally:
        os.unlink(path)
    for i, (c0, c1) in enumerate(sorted(t.spans[chrome_trace.CALL])):
        spans = {}
        for name, ivs in t.spans.items():
            inside = sum(e - s for s, e in ivs if s >= c0 and e <= c1)
            if name != chrome_trace.CALL and inside:
                spans[name[len(chrome_trace.SPAN):]] = inside
        busy = sum(min(e, c1) - max(s, c0) for s, e in t.busy if e > c0 and s < c1)
        launches = sum(1 for x in t.launches if c0 <= x <= c1)
        print(json.dumps({"traced": i, "wall_s": c1 - c0, "device_busy_s": busy,
                          "launches": launches, "spans_s": spans}), flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace-calls", type=int, default=0)
    args = ap.parse_args(argv)
    import importlib

    import torch

    from fhebench.run import ROOT, load_cell

    if not torch.cuda.is_available():
        print("fhebench: diagnose needs a CUDA card", file=sys.stderr)
        return 2
    os.environ.setdefault("CUDA_CACHE_PATH", str(ROOT / "build" / "cuda_cache"))
    torch.set_num_threads(1)
    cell = load_cell(args.workload)
    driver = importlib.import_module(f"fhebench.drivers.{cell.traffic['driver']}")
    drv = driver.Driver(cell.config, cell.traffic, args.seed, torch.device("cuda"))
    drv.setup()
    for req in drv.warm_requests():
        drv.serve(req)
    _untraced(drv, args.seconds)
    if args.trace_calls:
        _traced(drv, args.trace_calls)
    return 0


if __name__ == "__main__":
    sys.path[:] = [p for p in sys.path if Path(p or ".").resolve() != HERE]
    sys.path.insert(0, str(HERE.parent))
    sys.exit(main())
