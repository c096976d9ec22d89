"""BENCHMARK.json and the files it names: every cell loads by name, every
metric has its reader, every configuration equals the port's Params."""

from __future__ import annotations

import importlib
import json
import re

import pytest

from fhebench.drivers import common
from fhebench.run import ROOT, load_cell

SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in SPEC["workloads"]]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


@pytest.mark.parametrize("name", CELLS)
def test_every_cell_loads_by_name(name):
    cell = load_cell(name)
    importlib.import_module(f"fhebench.drivers.{cell.traffic['driver']}").Driver
    reported = [m["name"] for m in cell.end_to_end]
    assert "setup_s" in reported and len(reported) >= 2
    assert cell.per_layer, "every cell reports a per-layer metric"
    for m in cell.end_to_end + cell.per_layer:
        family = m["name"].partition(".")[0]
        assert callable(importlib.import_module(f"fhebench.metrics.{family}").read)
    assert cell.limits["wrong"] == 0
    assert 0 < cell.limits["noise_power"] < 1


def test_names_units_and_bounds_keep_the_contract():
    metrics = SPEC["end_to_end"] + SPEC["per_layer"]
    names = [x["name"] for x in SPEC["configs"] + SPEC["workloads"] + metrics]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    assert all(re.match(r"^[A-Za-z0-9_/%.-]{1,16}$", m["unit"]) for m in metrics)
    assert all(0.01 <= m["bound"] <= 0.25 for m in SPEC["end_to_end"])
    moved = {m["name"] for m in SPEC["end_to_end"]}
    assert all(m["moves"] in moved for m in SPEC["per_layer"])
    for w in SPEC["workloads"]:
        assert w["chips"] in (1, 4) and len(w["why"]) <= 200


@pytest.mark.parametrize("conf", SPEC["configs"], ids=lambda c: c["name"])
def test_configuration_equals_the_ports_params(conf):
    config = json.loads((ROOT / conf["file"]).read_text())
    assert config["name"] == conf["name"]
    params = common.scheme_params(common.program(), config)
    # the precision every run holds the rotations to is stated
    assert config["params"]["num_limbs"] == params.num_limbs
    assert 0 <= config["prune"] < config["params"]["num_digits"] == params.num_digits
    # inputs that decrypt right
    assert 0 < 2 * config["input_noise"] < params.Dr


def test_a_changed_parameter_is_refused():
    config = json.loads((ROOT / "fhebench/configs/gao18-n512.json").read_text())
    config["params"]["moduli"] = config["params"]["moduli"][:2]
    with pytest.raises(RuntimeError, match="moduli"):
        common.scheme_params(common.program(), config)
