"""The readers of the port's own spans (program_spans.py and the metrics
switch_idle_pct, rotate_idle_pct and switch_launches): a made-up Chrome
trace and a made-up record of the port, counted by hand; a record that
leaves the window, or a port without a record, reads as nothing; and on
the CPU, the record of a real traced call lies in the harness's window and
its `rotate` span lies in the range hooks.py puts around the same
rotation."""

from __future__ import annotations

import importlib
import json

import pytest

from fhebench import program_spans
from fhebench.chrome_trace import CALL, Trace
from fhebench.run import Run

profiling = pytest.importorskip("sgfhe_tpu_torch.utils.profiling")

#: A trace's zero: a whole multiple of libkineto's base period.
BASE_NS = 227 * profiling.TRACE_BASE_PERIOD_S * 10**9
READERS = ("switch_idle_pct", "rotate_idle_pct", "switch_launches")


def _x(cat, name, ts, dur, corr=None):
    ev = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}
    if corr is not None:
        ev["args"] = {"correlation": corr}
    return ev


# microseconds: the call 0-100; kernels 20-40, 45-55 (launched in rotate),
# 64-66, 67-68 (in the first switch), 74-76 (the second), 92-95 (gates)
EVENTS = [_x("user_annotation", CALL, 0, 100)] + [
    _x("cuda_runtime", "cudaLaunchKernel", t, 0.5, corr=i)
    for i, t in enumerate((12, 30, 63, 65, 73, 90))
] + [_x("kernel", "k", s, e - s, corr=i)
     for i, (s, e) in enumerate(((20, 40), (45, 55), (64, 66), (67, 68), (74, 76), (92, 95)))]

# (name, start, end) in microseconds of the trace, in the order they end
SPANS = [("rotate", 10, 50), ("bootstrap", 5, 60), ("switch", 62, 70), ("switch", 72, 80),
         ("gates", 2, 98)]


def _record(spans=SPANS):
    return [(name, BASE_NS + s * 1000, BASE_NS + e * 1000) for name, s, e in spans]


@pytest.fixture
def run(tmp_path, monkeypatch):
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": EVENTS}))
    monkeypatch.setattr(profiling, "spans", _record)
    return Run(setup_s=0.0, trace=Trace.load(path))


def _read(name, run):
    return importlib.import_module(f"fhebench.metrics.{name}").read(run, "x")


def test_idle_gaps_go_to_the_innermost_program_span(run):
    us = 1e-6
    # gaps: 0-20 before any span, 40-45 in rotate, 55-64 in bootstrap,
    # 66-67, 68-74 and 76-92 in a switch, 95-100 in gates
    assert program_spans.idle_seconds_in(run, "switch") == pytest.approx(23 * us)
    assert program_spans.idle_seconds_in(run, "rotate") == pytest.approx(5 * us)
    assert program_spans.idle_seconds_in(run, "bootstrap") == pytest.approx(9 * us)
    assert program_spans.idle_seconds_in(run, "gates") == pytest.approx(5 * us)
    assert program_spans.launches_in(run, "switch") == 3
    assert program_spans.launches_in(run, "rotate") == 2
    assert program_spans.count(run, "bootstrap") == 1


def test_readers_count_as_by_hand(run):
    got = {name: _read(name, run) for name in READERS}
    assert got == {"switch_idle_pct": pytest.approx(23.0), "rotate_idle_pct": pytest.approx(5.0),
                   "switch_launches": 3.0}


@pytest.mark.parametrize("spans", [
    SPANS[:3] + [("switch", 72, 101)] + SPANS[4:],  # ends after the window
    SPANS[:4] + [("gates", -1, 98)],                 # starts before it
    [("rotate", -30, -20)] + SPANS[1:],              # lies wholly before it
], ids=["late", "early", "before"])
def test_a_span_outside_the_window_reads_nothing(run, monkeypatch, spans):
    monkeypatch.setattr(profiling, "spans", lambda: _record(spans))
    assert program_spans.mapped(run) is None
    assert all(_read(name, run) is None for name in READERS)


@pytest.mark.parametrize("port", ["no record", "empty record", "no device ops"])
def test_nothing_to_read_reads_nothing(run, monkeypatch, port):
    if port == "no record":
        monkeypatch.delattr(profiling, "spans")
    elif port == "empty record":
        monkeypatch.setattr(profiling, "spans", lambda: [])
    else:
        run.trace.device_ops = []
    assert all(_read(name, run) is None for name in READERS)


def test_a_cpu_call_lies_in_the_window_and_rotate_in_the_hooks_range(tmp_path):
    """A Params(64) gate batch on the CPU, traced as run.py's traced run
    traces a call: every span of the record lies in the window, and the
    one `rotate` span lies inside the range hooks.py puts around the one
    rotation it counts."""
    torch = pytest.importorskip("torch")
    from torch.profiler import record_function

    import sgfhe_tpu_torch as T
    from fhebench import hooks

    torch.set_num_threads(1)
    params = T.Params.create(64)
    ctx = T.make_context(params, device="cpu")
    g = torch.Generator().manual_seed(5)
    sk = T.PrivateKey.create(params, g, device="cpu")
    bk = T.BootstrapKey.create(ctx, sk, g)
    bits = T.split_ciphertext(T.encrypt(sk, g, torch.randint(0, 2, (params.n,),
                                                             generator=g))).lwe
    lwe1, lwe2 = T.LWE(bits.a[0:6:2], bits.b[0:6:2]), T.LWE(bits.a[1:6:2], bits.b[1:6:2])
    with hooks.installed(()) as rotations, profiling.trace(str(tmp_path)):
        with record_function(CALL):
            T.bootstrap_batch(params, ctx, bk.hat, bk.hat_shoup, lwe1, lwe2,
                              (3, 4), epoch=1, prune=1)
    (path,) = tmp_path.glob("*.json")
    run = Run(setup_s=0.0, trace=Trace.load(path))
    mapped = program_spans.mapped(run)
    assert sorted(name for _, _, name in mapped) == sorted(
        ["gates", "bootstrap", "rotate"] + ["switch"] * 6)
    (rotate,) = [(s, e) for s, e, name in mapped if name == "rotate"]
    (wrapped,) = run.trace.spans["fhebench:blind_rotate"]
    assert len(rotations) == 1
    assert wrapped[0] - 100e-6 <= rotate[0] and rotate[1] <= wrapped[1] + 100e-6
    # the CPU trace has no device operations: the readers find nothing
    assert all(_read(name, run) is None for name in READERS)
