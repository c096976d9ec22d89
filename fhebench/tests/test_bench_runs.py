"""Whole runs of toy cells on the CPU (the port's plain versions run where
the kernels would): sound runs come out correct, the reference agrees with
the port's own decryption, and each fault a cell can have, and the
control, make `correct` come out false. The harness's look for a card is
skipped: run_cell is called with device="cpu"."""

from __future__ import annotations

import importlib
import json
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

import bench_toy
from fhebench.reference import lwe
from fhebench.run import ROOT, run_cell

SEED = 2**31 + 77
KINDS = sorted(bench_toy.TRAFFIC)


def _run(kind, traced=False, control=None):
    return run_cell(bench_toy.cell(kind), SEED, 0.5, traced, device="cpu",
                    start=time.perf_counter(), control=control)


@pytest.mark.parametrize("kind", KINDS)
def test_sound_toy_run_is_correct(kind):
    res = _run(kind)
    assert res["correct"] and res["failed"] == 0 and res["attempted"] > 0
    assert list(res)[-1] == "checks"
    assert set(res["metrics"]) == {bench_toy.UNIT[kind], "setup_s"}
    # the warm requests' rotations ran at the configuration's L and l
    assert res["checks"]["limbs"] == {"value": 3, "limit": 3}
    assert res["checks"]["digits"] == {"value": 3, "limit": 3}


def test_traced_toy_run_judges_its_calls():
    res = _run("circuits", traced=True)
    # one ripple_adder(2) (3 outputs) and one comparator(2) (2), 4 instances
    assert res["correct"] and res["attempted"] == (3 + 2) * 4
    assert res["device"]["window_s"] > 0 and "breakdown" in res
    # host spans read on the CPU; device metrics find nothing to read
    assert set(res["metrics"]) == {"rotate_host_ms.toy", "switch_host_ms.toy"}


@pytest.mark.parametrize("kind", ["gates", "digits"])
def test_reference_agrees_with_the_ports_decryption(kind):
    import sgfhe_tpu_torch as T

    cell = bench_toy.cell(kind)
    module = importlib.import_module(f"fhebench.drivers.{cell.traffic['driver']}")
    drv = module.Driver(cell.config, cell.traffic, SEED, torch.device("cpu"))
    drv.setup()
    req = drv.request(0)
    out = drv.serve(req)
    p = drv.params
    for (a, b), want in zip(out, drv.expected(req)):
        ph = lwe.phases(a.numpy(), b.numpy(), drv.secret, p.r)
        mine = ((ph + p.Dr // 2) % p.r) // p.Dr
        if kind == "gates":
            ports = T.decrypt_bit(T.PrivateKey(p, torch.from_numpy(drv.secret)),
                                  T.EncryptedBit(T.LWE(a, b))).numpy()
            assert np.array_equal(mine != 0, ports)
        else:
            sk = T.Scheme2.PrivateKey(p, torch.from_numpy(drv.secret))
            ports = T.Scheme2Boot.decrypt_lwe(sk, T.LWE(a, b)).numpy()
            assert np.array_equal(mine, ports)
        assert np.array_equal(mine, want)


def _unchanged_state(monkeypatch):
    """Every rotation step returns its state unchanged."""
    from sgfhe_tpu_torch.models import bootstrap

    monkeypatch.setattr(bootstrap, "_external_step",
                        lambda params, ctx, a, b, *rest, **kw: (a, b))


def _half_batch(monkeypatch):
    """The rotation leaves out the second half of its lanes (zeros there)."""
    from sgfhe_tpu_torch.models import bootstrap, bootstrap2

    orig = bootstrap.blind_rotate

    def half(params, ctx, bkey_hat, bkey_shoup, ua, a_acc, b_acc, seed2=None, prune=0,
             **kw):
        h = ua.shape[0] // 2
        ra, rb = orig(params, ctx, bkey_hat, bkey_shoup, ua[:h], a_acc[:h], b_acc[:h],
                      seed2, prune, **kw)
        return (torch.cat([ra, torch.zeros_like(a_acc[h:])]),
                torch.cat([rb, torch.zeros_like(b_acc[h:])]))

    monkeypatch.setattr(bootstrap, "blind_rotate", half)
    monkeypatch.setattr(bootstrap2, "blind_rotate", half)


def _altered_answer(monkeypatch):
    """The first answer of each Q->r switch moved by Dr: another message."""
    from sgfhe_tpu_torch.models import bootstrap, bootstrap2

    for mod, name in ((bootstrap, "_reduce_lwe"), (bootstrap2, "_rotate_extract")):
        orig = getattr(mod, name)

        def altered(params, *args, __orig=orig, **kw):
            out = __orig(params, *args, **kw)
            out.b[0] = (out.b[0] + params.Dr) % params.r
            return out

        monkeypatch.setattr(mod, name, altered)


FAULTS = {"unchanged_state": _unchanged_state, "half_batch": _half_batch,
          "altered_answer": _altered_answer}


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("kind", KINDS)
def test_each_fault_makes_correct_false(kind, fault, monkeypatch):
    FAULTS[fault](monkeypatch)
    res = _run(kind)
    assert not res["correct"] and res["failed"] > 0


@pytest.mark.parametrize("control", [{"limbs": 2}, {"prune": 1}], ids=["limbs2", "prune1"])
@pytest.mark.parametrize("kind", KINDS)
def test_control_makes_correct_false(kind, control):
    res = _run(kind, control=control)
    assert not res["correct"]
    checks = res["checks"]
    if "limbs" in control:
        assert checks["limbs"]["value"] == 2 < checks["limbs"]["limit"]
        assert checks["noise_power"]["value"] > checks["noise_power"]["limit"]
    else:
        assert checks["digits"]["value"] == 2 < checks["digits"]["limit"]


def test_no_rotation_counted_is_not_correct(monkeypatch):
    """A rotation the hooks cannot see (an entry bound elsewhere) reads 0
    limbs and digits, and the run is not correct."""
    from fhebench import hooks

    monkeypatch.setattr(hooks, "ROTATE", ())
    res = _run("gates")
    assert res["failed"] == 0 and not res["correct"]
    assert res["checks"]["limbs"]["value"] == res["checks"]["digits"]["value"] == 0


_PROBE = """
import json, sys, time
sys.path[:0] = [{root!r}, {tests!r}]
{body}
top = sorted({{m.partition('.')[0] for m in sys.modules}})
print(json.dumps(top))
"""


def _modules_after(body: str) -> set:
    code = _PROBE.format(root=str(ROOT), tests=str(ROOT / "fhebench" / "tests"), body=body)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_a_dry_run_loads_no_jax():
    loaded = _modules_after(
        "import bench_toy\nfrom fhebench.run import run_cell, forbidden_modules\n"
        "res = run_cell(bench_toy.cell('gates'), 5, 0.2, True, device='cpu')\n"
        "assert res['correct'] and forbidden_modules() == []")
    assert "sgfhe_tpu_torch" in loaded
    assert not loaded & {"jax", "jaxlib", "flax", "sgfhe_tpu"}


def test_the_reference_loads_nothing_of_the_port():
    loaded = _modules_after("import fhebench.reference.lwe, fhebench.reference.plain")
    assert not loaded & {"sgfhe_tpu_torch", "sgfhe_tpu", "jax", "torch"}
