"""The reading of a profiler trace: a made-up Chrome trace on the CPU, and a
real one on the card."""

from __future__ import annotations

import json

import pytest

from fhebench.chrome_trace import Trace


def _x(cat, name, ts, dur, corr=None):
    ev = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}
    if corr is not None:
        ev["args"] = {"correlation": corr}
    return ev


EVENTS = [
    _x("user_annotation", "fhebench:call", 0, 100),
    _x("user_annotation", "fhebench:bootstrap_internal", 5, 80),
    _x("user_annotation", "fhebench:blind_rotate", 10, 40),
    _x("user_annotation", "fhebench:reduce_lwe", 60, 20),
    _x("gpu_user_annotation", "fhebench:call", 0, 100),  # not device work
    _x("cuda_runtime", "cudaLaunchKernel", 12, 1, corr=1),
    _x("cuda_runtime", "cudaLaunchKernel", 30, 1, corr=2),
    _x("cuda_runtime", "cudaLaunchKernel", 65, 1, corr=3),
    _x("cuda_runtime", "cudaMemcpyAsync", 90, 1, corr=4),
    _x("kernel", "rotate", 20, 30, corr=1),
    _x("kernel", "rotate", 50, 10, corr=2),
    _x("kernel", "switch", 70, 5, corr=3),
    _x("gpu_memcpy", "Memcpy DtoH", 92, 4, corr=4),
]


def test_made_up_trace_reads_as_counted_by_hand(tmp_path):
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": EVENTS}))
    t = Trace.load(path)
    us = 1e-6
    assert t.window == (0, 100 * us)
    assert t.busy_s == pytest.approx(49 * us)  # 20-60, 70-75, 92-96
    assert t.span_count("bootstrap_internal") == 1
    assert t.span_seconds("blind_rotate") == pytest.approx(40 * us)
    assert t.launches_in("call") == 3 and t.launches_in("blind_rotate") == 2
    assert t.device_seconds_launched_in("blind_rotate") == pytest.approx(40 * us)
    assert t.device_seconds_launched_in("reduce_lwe") == pytest.approx(5 * us)
    assert t.device_ops_by_name() == [["rotate", pytest.approx(40 * us)],
                                      ["switch", pytest.approx(5 * us)],
                                      ["Memcpy DtoH", pytest.approx(4 * us)]]
    gaps = dict(t.idle_gaps_by_span())
    # 0-20 and 96-100 begin in call alone, 60-70 and 75-92 in reduce_lwe
    assert gaps == {"call": pytest.approx(24 * us), "reduce_lwe": pytest.approx(27 * us)}


@pytest.mark.cuda
def test_card_trace_links_kernels_to_their_launches(tmp_path):
    torch = pytest.importorskip("torch")
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from torch.profiler import ProfilerActivity, profile, record_function

    x = torch.ones(1 << 20, device="cuda")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with record_function("fhebench:call"):
            with record_function("fhebench:blind_rotate"):
                y = x * 2
            (y + 1).cpu()
    path = tmp_path / "t.json"
    prof.export_chrome_trace(str(path))
    t = Trace.load(path)
    assert t.busy_s > 0 and t.window_s > t.busy_s
    assert t.launches_in("call") >= 2 and t.launches_in("blind_rotate") >= 1
    assert 0 < t.device_seconds_launched_in("blind_rotate") < t.busy_s


def test_kernel_names_lose_their_arguments_only():
    from fhebench.chrome_trace import _short

    assert _short("void flatten_ntt_fwd_kernel<3, false>(unsigned int const*, int)") == \
        "void flatten_ntt_fwd_kernel<3, false>"
    assert _short("void at::native::(anonymous namespace)::CatArrayBatchedCopy<int>(int*)") == \
        "void at::native::(anonymous namespace)::CatArrayBatchedCopy<int>"
    assert _short("Memcpy HtoD (Pageable -> Device)") == "Memcpy HtoD (Pageable -> Device)"


def test_a_metrics_spans_are_wrapped_while_installed():
    """A reader's SPANS are wrapped with the breakdown's, and restored."""
    from sgfhe_tpu_torch import circuit

    from fhebench import hooks
    from fhebench.run import spans_of

    declared = spans_of([{"name": "switch_host_ms.x"}, {"name": "device_idle_pct.x"}])
    assert ("sgfhe_tpu_torch.models.bootstrap", "_reduce_lwe", "reduce_lwe") in declared
    extra = (("sgfhe_tpu_torch.circuit", "evaluate_internal", "evaluate_internal"),)
    plain = circuit.evaluate_internal
    with hooks.installed(extra):
        assert circuit.evaluate_internal is not plain
    assert circuit.evaluate_internal is plain
    with hooks.installed(None):  # the rotations alone
        assert circuit.evaluate_internal is plain
