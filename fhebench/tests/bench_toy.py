"""Toy cells for the CPU tests: the benchmark's drivers and checks at sizes
a test run holds (the port's plain versions run where the kernels would)."""

from __future__ import annotations

from fhebench.run import Cell

#: Toy limits of the noise power, between the readings of four seeds of the
#: CPU runs (batch as below, 0.3-s windows): scheme 1 at n = 64 at most
#: 1.6e-4 as configured, at least 4.4e-4 as the control; scheme 2 at k = 2,
#: n = 64 at most 5.2e-4, and at least 1.7e-2.
LIMITS = {1: {"wrong": 0, "noise_power": 3e-4}, 2: {"wrong": 0, "noise_power": 5e-3}}
SCHEME1 = {"name": "toy-n64", "scheme": 1, "n": 64, "params": {"n": 64, "m": 512, "num_limbs": 3, "num_digits": 3},
           "prune": 0, "input_noise": 32}
SCHEME2 = {"name": "toy-k2-n64", "scheme": 2, "k": 2, "n": 64,
           "params": {"n": 64, "k": 2, "m": 1024, "num_limbs": 3,
                      "num_digits": 3}, "prune": 0, "input_noise": 16}
TRAFFIC = {
    "gates": {"driver": "gates", "mode": "exact", "batch": 8, "pool": 64, "trace_calls": 1},
    "digits": {"driver": "digits", "mode": "randomized", "batch": 4, "pool": 16,
               "trace_calls": 1},
    "circuits": {"driver": "circuits", "mode": "exact", "instances": 4, "pool": 64,
                 "circuits": [["ripple_adder", 2], ["comparator", 2]], "close_every": 2,
                 "trace_calls": 2},
}
CONFIG = {"gates": SCHEME1, "digits": SCHEME2, "circuits": SCHEME1}
UNIT = {"gates": "gates_per_s", "digits": "adds_per_s", "circuits": "circuit_ms"}


def cell(driver: str) -> Cell:
    e2e = [{"name": UNIT[driver], "unit": "x"}, {"name": "setup_s", "unit": "s"}]
    layer = [{"name": n, "unit": "x"} for n in (
        "device_idle_pct.toy", "rotation_roofline.toy", "rotate_host_ms.toy",
        "switch_host_ms.toy", "launches_per_level.toy")]
    return Cell(name=f"toy-{driver}", chips=1, config=CONFIG[driver],
                traffic=TRAFFIC[driver], limits=LIMITS[CONFIG[driver]["scheme"]],
                end_to_end=e2e, per_layer=layer)
