"""The port's tooling against the JAX package's: progress lines
(sgfhe_tpu_torch/utils/progress.py), the analytic cost model `op_cost`
(utils/profiling.py, equal field for field), `timeit` and `trace` on the
CPU, and `prewarm` (its stage keys and signature), all on the CPU."""

import inspect
import os
import re

import pytest

torch = pytest.importorskip("torch")
# The twins issue many small ops: one thread each, or the parallel test
# workers oversubscribe the cores and run many times slower.
torch.set_num_threads(1)

import sgfhe_tpu as F  # noqa: E402
from sgfhe_tpu.utils import profiling as rprof  # noqa: E402
from sgfhe_tpu.utils import progress as rprog  # noqa: E402

import sgfhe_tpu_torch as T  # noqa: E402
from sgfhe_tpu_torch.utils import profiling as tprof  # noqa: E402
from sgfhe_tpu_torch.utils import progress as tprog  # noqa: E402

_CLOCK = re.compile(r"\+ *[0-9.]+s|in [0-9.]+s$")


def _lines(mod, capsys):
    """What `mod` prints for one log line and one stage, with the clock
    readings blanked."""
    mod.log("building tables (m=512, L=3)")
    with mod.stage("BootstrapKey.create n=64"):
        pass
    err = capsys.readouterr().err
    return [_CLOCK.sub("#", line) for line in err.splitlines()]


@pytest.mark.parametrize("switch", ["enable", "env", "env-0", "disable"])
def test_progress_lines_equal_reference(switch, monkeypatch, capsys):
    for mod in (rprog, tprog):
        monkeypatch.setattr(mod, "_FORCED", None)
    if switch == "enable":
        for mod in (rprog, tprog):
            mod.enable(True)
    elif switch == "disable":
        monkeypatch.setenv("SGFHE_PROGRESS", "1")
        for mod in (rprog, tprog):
            mod.enable(False)
    else:
        monkeypatch.setenv("SGFHE_PROGRESS", "1" if switch == "env" else "0")
    ref, got = _lines(rprog, capsys), _lines(tprog, capsys)
    assert got == ref
    assert tprog.enabled() == rprog.enabled() == (switch in ("enable", "env"))
    assert len(got) == (3 if switch in ("enable", "env") else 0)
    if got:
        assert got[0] == "[sgfhe #] building tables (m=512, L=3)"
        assert got[2] == "[sgfhe #] BootstrapKey.create n=64 done #"


def test_key_builders_narrate(monkeypatch, capsys):
    monkeypatch.setattr(tprog, "_FORCED", True)
    params = T.Params.create(64)
    ctx = T.make_context(params, device="cpu")
    sk = T.PrivateKey.create(params, torch.Generator().manual_seed(1), device="cpu")
    T.BootstrapKey.create(ctx, sk, torch.Generator().manual_seed(2))
    err = capsys.readouterr().err
    assert "make_context n=64: building NTT/RNS tables (m=512, L=3) on the host CPU" in err
    stage = ("BootstrapKey create (GSW rows and companions on the host CPU) n=64 "
             "(4 MiB hat and 4 MiB companions, 1 chunks)")
    assert f"{stage} ..." in err
    assert re.search(re.escape(stage) + r" done in [0-9.]+s", err)


@pytest.mark.parametrize("n", [64, 512, 1024])
@pytest.mark.parametrize("prune", [0, 1, 2])
def test_op_cost_equals_reference(n, prune):
    ref = rprof.op_cost(F.Params.create(n), prune)
    got = tprof.op_cost(T.Params.create(n), prune)
    assert type(got).__name__ == type(ref).__name__ == "GateCost"
    for field in ("sme_per_gate", "ntt_transforms", "key_bytes", "acc_bytes"):
        assert getattr(got, field) == getattr(ref, field), field


def test_timeit_and_trace_on_cpu(tmp_path):
    x = torch.arange(1024, dtype=torch.int64)
    sec, out = tprof.timeit(lambda v: (v * 3) % 7, x, iters=3, warmup=2)
    assert sec > 0 and torch.equal(out, (x * 3) % 7)
    with tprof.trace(str(tmp_path / "tr")):
        (x * x).sum()
    files = os.listdir(tmp_path / "tr")
    assert len(files) == 1 and files[0].endswith(".json")
    assert (tmp_path / "tr" / files[0]).stat().st_size > 0


def test_prewarm_stage_keys_and_signature_equal_reference():
    ref = inspect.signature(F.prewarm).parameters
    got = inspect.signature(T.prewarm).parameters
    for name, p in ref.items():
        assert got[name].default == p.default, name
    timings = T.prewarm(T.Params.create(64), device="cpu", batch=8, verbose=False)
    assert set(timings) == {"context", *ref["modes"].default}
    assert all(v >= 0 for v in timings.values())
