"""Run one cell of the benchmark of sgfhe_tpu_torch once, and print its
result as the last line of standard output.

    python3 fhebench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout, on a machine with the cards the cell asks
for. The cell, its configuration and its traffic are read from
BENCHMARK.json and the files it names (see fhebench/__init__.py). A run:

  1. set-up: builds the port's kernels (into the checkout's build/, so only
     a checkout's first run compiles), makes the secret key, the port's
     context and bootstrap key on the card from --seed, encrypts the pool
     of inputs, and serves one warm request of each of the cell's shapes;
     `setup_s` is the time from the start of the process to here;
  2. --trace 0: serves requests back to back, one client in a closed loop,
     for --seconds, the window closing at the end of a whole request (of a
     whole turn of the traffic's `close_every` requests); each request ends
     when its answers are on the host; the cell's end-to-end metrics;
     --trace 1: serves the traffic's `trace_calls` requests under
     torch.profiler with the spans of hooks.py; the cell's per-layer
     metrics, the device's busy and window seconds, and the breakdown;
  3. reads the peak device memory, frees the port's state, and judges every
     answer of the window with the plain reference (reference/): the
     answers that decrypt wrong, against the limit 0, and the noise power
     (the answers' mean squared noise over (Dr/2)^2, the square of the
     distance at which decryption fails), against the cell's limit
     (limits/<cell>.json). It also holds the rotations that the warm
     requests (and a traced run's calls) made, as hooks.py counted them
     from the tensors `blind_rotate` received, to the configuration's
     precision: the fewest limbs of any accumulator against its L
     (`num_limbs`), the fewest key digits kept against its l
     (`num_digits`) less its `prune`; no rotation counted reads 0. Each
     number compared is printed beside its limit as the last lines of
     standard error and under "checks", last in the result.

It exits nonzero and prints no result without a CUDA card (or with fewer
than the cell asks for), without the port beside it, or if JAX or the JAX
package was loaded.
"""

from __future__ import annotations

import time

_START = time.perf_counter()

import argparse  # noqa: E402
import dataclasses  # noqa: E402
import gc  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
#: Top-level module names no run may load, compared whole.
FORBIDDEN = ("jax", "jaxlib", "flax", "sgfhe_tpu")


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list
    per_layer: list


@dataclasses.dataclass
class Run:
    """What the metric readers (metrics/) read."""

    setup_s: float
    window_s: float = 0.0
    work: dict = dataclasses.field(default_factory=dict)
    trace: object = None  # chrome_trace.Trace of the traced run
    rotations: list = dataclasses.field(default_factory=list)


def load_cell(name: str, root: Path = ROOT) -> Cell:
    """The cell `name` of root/BENCHMARK.json with its files and metrics: the
    end-to-end metrics that list it (or list no cell), the per-layer
    metrics that list it (or list no cell and move a metric it reports)."""
    spec = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in spec["workloads"]}
    if name not in cells:
        raise SystemExit(f"fhebench: no cell {name!r} in BENCHMARK.json")
    w = cells[name]
    conf = {c["name"]: c for c in spec["configs"]}[w["config"]]
    e2e = [m for m in spec["end_to_end"] if name in m.get("workloads", [name])]
    moved = {m["name"] for m in e2e}
    layer = [m for m in spec["per_layer"]
             if name in m.get("workloads", [name] if m["moves"] in moved else [])]
    return Cell(
        name=name, chips=w["chips"],
        config=json.loads((root / conf["file"]).read_text()),
        traffic=json.loads((HERE / "traffic" / f"{w['traffic']}.json").read_text()),
        limits=json.loads((HERE / "limits" / f"{name}.json").read_text()),
        end_to_end=e2e, per_layer=layer,
    )


def _reader(metric: dict):
    """The module that reads `metric`: metrics/<family>.py of its name's
    part before the first dot."""
    return importlib.import_module(f"fhebench.metrics.{metric['name'].partition('.')[0]}")


def read_metrics(metrics: list, run: Run) -> dict:
    """Each metric from the reader of its family (metrics/<family>.py);
    a reader that finds nothing leaves its metric out."""
    out = {}
    for m in metrics:
        value = _reader(m).read(run, m["name"].partition(".")[2])
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def spans_of(metrics: list) -> tuple:
    """The (module, attribute, span) triples that the metrics' readers
    declare in their SPANS, for hooks.installed."""
    return tuple(t for m in metrics for t in getattr(_reader(m), "SPANS", ()))


def _window(drv, seconds: float, close_every: int, served: list, run: Run) -> None:
    t0 = time.perf_counter()
    ends, cpu = [], [time.thread_time()]
    while True:
        req = drv.request(len(ends))
        served.append((req, drv.serve(req)))
        ends.append(time.perf_counter() - t0)
        cpu.append(time.thread_time())
        if ends[-1] >= seconds and len(ends) % close_every == 0:
            break
    run.window_s = ends[-1]
    run.work = {unit: count * len(ends) for unit, count in drv.work.items()}
    took = [b - a for a, b in zip([0.0] + ends, ends)]
    mid = sorted(took)[len(took) // 2]
    print(f"fhebench: window {run.window_s:.3f} s, {len(took)} requests of {min(took):.4f} "
          f"to {max(took):.4f} s, median {mid:.4f}", file=sys.stderr)
    # each request's wall and its thread's CPU seconds: a host-bound cell's
    # slow requests take more CPU for the same launches (PERF.md)
    print("fhebench: requests (wall s, thread CPU s): " + " ".join(
        f"{w:.4f},{c1 - c0:.4f}" for w, c0, c1 in zip(took, cpu, cpu[1:])), file=sys.stderr)


def _traced(drv, calls: int, spans: tuple, served: list, run: Run) -> None:
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from fhebench import chrome_trace, hooks

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with hooks.installed(spans) as rotations, profile(activities=activities) as prof:
        for i in range(calls):
            with record_function(chrome_trace.CALL):
                req = drv.request(i)
                served.append((req, drv.serve(req)))
    run.rotations = rotations
    fd, path = tempfile.mkstemp(prefix="fhebench-trace-", suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        run.trace = chrome_trace.Trace.load(path)
    finally:
        os.unlink(path)


def _judge(served: list, expected: list, secret, r: int, Dr: int) -> tuple[int, int, float]:
    """(answers, wrong, noise power) over every answer served: the noise
    power is the mean squared noise over (Dr/2)^2, the square of the
    distance at which decryption fails. An answer batch that is missing or
    of the wrong size counts wholly wrong, at the power of a uniform
    phase."""
    from fhebench.reference import lwe

    answers = wrong = 0
    squares = 0.0
    for (_, out), want in zip(served, expected):
        for i, w in enumerate(want):
            w = w.reshape(-1)
            if i >= len(out) or out[i][0].shape[0] != w.size:
                answers, wrong, squares = answers + w.size, wrong + w.size, \
                    squares + w.size * r * r / 12
                continue
            got = lwe.judge(out[i][0].numpy(), out[i][1].numpy(), secret, r, Dr, w)
            answers, wrong, squares = answers + got[0], wrong + got[1], squares + got[2]
    return answers, wrong, squares / max(answers, 1) / (Dr / 2) ** 2


def precision(config: dict, rotations: list) -> dict:
    """The rotations' precision against the configuration's: the fewest
    limbs of any rotation's accumulators against L, the fewest key digits
    kept against l less the configuration's prune (0 where none was
    counted)."""
    stated = config["params"]
    return {"limbs": {"value": min((r["L"] for r in rotations), default=0),
                      "limit": stated["num_limbs"]},
            "digits": {"value": min((r["lk"] for r in rotations), default=0),
                       "limit": stated["num_digits"] - config["prune"]}}


def run_cell(cell: Cell, seed: int, seconds: float, traced: bool, device: str = "cuda",
             start: float = _START, control: dict | None = None) -> dict:
    """One run of `cell`; returns the result line as a dict. `control`
    (readings.py) changes the configuration the port runs: {"limbs": N}
    cuts Q to its first N primes, {"prune": N} prunes N gadget digits."""
    import torch

    from fhebench import hooks

    torch.set_num_threads(1)
    dev = torch.device(device)
    driver = importlib.import_module(f"fhebench.drivers.{cell.traffic['driver']}")
    drv = driver.Driver(cell.config, cell.traffic, seed, dev, control)
    t_keys = time.perf_counter()
    drv.setup()
    t_warm = time.perf_counter()
    with hooks.installed(None) as rotations:
        for req in drv.warm_requests():
            drv.serve(req)
    run = Run(setup_s=time.perf_counter() - start)
    print(f"fhebench: set-up {run.setup_s:.3f} s: start and imports {t_keys - start:.3f}, "
          f"keys and inputs {t_warm - t_keys:.3f}, warm requests (the kernels' build "
          f"in a checkout's first run) {start + run.setup_s - t_warm:.3f}", file=sys.stderr)
    served: list = []
    if traced:
        _traced(drv, cell.traffic["trace_calls"], spans_of(cell.per_layer), served, run)
        rotations += run.rotations
    else:
        _window(drv, seconds, cell.traffic.get("close_every", 1), served, run)
    cuda = dev.type == "cuda"
    peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    expected = [drv.expected(req) for req, _ in served]
    secret, r, Dr = drv.secret, drv.params.r, drv.params.Dr
    drv.close()
    del drv
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    attempted, failed, power = _judge(served, expected, secret, r, Dr)
    limits = cell.limits
    held = precision(cell.config, rotations)
    device_block = {"platform": "gpu" if cuda else "cpu",
                    "kind": torch.cuda.get_device_name(dev) if cuda else "cpu",
                    "count": cell.chips, "memory_peak_bytes": peak}
    result = {
        "correct": attempted > 0 and failed <= limits["wrong"]
                   and power <= limits["noise_power"]
                   and all(c["value"] >= c["limit"] for c in held.values()),
        "attempted": attempted, "failed": failed,
        "metrics": read_metrics(cell.per_layer if traced else cell.end_to_end, run),
        "device": device_block,
    }
    if traced:
        device_block["busy_s"] = run.trace.busy_s
        device_block["window_s"] = run.trace.window_s
        result["breakdown"] = {"device_ops": run.trace.device_ops_by_name(),
                               "idle_gaps": run.trace.idle_gaps_by_span()}
    result["checks"] = {"wrong": {"value": failed, "limit": limits["wrong"]},
                        "noise_power": {"value": power, "limit": limits["noise_power"]},
                        **held}
    return result


def forbidden_modules() -> list:
    """Loaded modules whose top-level name, whole, is forbidden."""
    return sorted({name.partition(".")[0] for name in sys.modules} & set(FORBIDDEN))


def report(result: dict) -> None:
    """The checks as the last lines of standard error, then the result as
    the last line of standard output."""
    sys.stdout.flush()
    for name, c in result["checks"].items():
        at = "at least" if name in ("limbs", "digits") else "at most"
        print(f"check {name}: {c['value']} (limit {c['limit']}, {at})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    # every build and kernel cache inside the checkout, at fixed paths
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"), ("CUDA_CACHE_PATH", "cuda_cache")):
        os.environ[var] = str(ROOT / "build" / sub)
    cell = load_cell(args.workload)

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"fhebench: {args.workload} needs {cell.chips} CUDA card(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace))
    found = forbidden_modules()
    if found:
        print(f"fhebench: the run loaded {found}", file=sys.stderr)
        return 3
    report(result)
    return 0


if __name__ == "__main__":
    sys.path[:] = [p for p in sys.path if Path(p or ".").resolve() != HERE]
    sys.path.insert(0, str(ROOT))
    sys.exit(main())
