"""The traffic drivers are deterministic under a seed: the same seed gives
the same keys, pools and requests, another seed others (toy sizes, CPU)."""

from __future__ import annotations

import importlib

import numpy as np
import pytest
import torch

import bench_toy

SEED = 2**31 + 12345


def _driver(kind: str, seed: int):
    cell = bench_toy.cell(kind)
    module = importlib.import_module(f"fhebench.drivers.{cell.traffic['driver']}")
    drv = module.Driver(cell.config, cell.traffic, seed, torch.device("cpu"))
    drv.setup()
    return drv


def _requests(drv, count=4):
    out = []
    for i in range(count):
        req = drv.request(i)
        out.append(req[1] if isinstance(req, tuple) else req)
    return out


def _state(drv):
    pools = getattr(drv, "pools", None) or [drv.pool]
    return [drv.secret] + [x.numpy() for pool in pools for x in pool]


@pytest.mark.parametrize("kind", sorted(bench_toy.TRAFFIC))
def test_same_seed_same_inputs_other_seed_others(kind):
    one, two, other = _driver(kind, SEED), _driver(kind, SEED), _driver(kind, SEED + 1)
    assert all(np.array_equal(x, y) for x, y in zip(_state(one), _state(two)))
    assert torch.equal(one.bkey.hat, two.bkey.hat)
    assert one.words == two.words
    assert all(np.array_equal(x, y) for x, y in zip(_requests(one), _requests(two)))
    assert not np.array_equal(one.secret, other.secret)
    assert not all(np.array_equal(x, y) for x, y in zip(_requests(one), _requests(other)))
    # every seed gives the same sizes
    assert [x.shape for x in _requests(one)] == [x.shape for x in _requests(other)]
