"""Each example of the port (sgfhe_tpu_torch/examples/) runs its `main` on
the CPU at a small size, and its own checks pass: every sum of the adder,
every generation of the depth soak, the noise report of `errors` inside
the decision boundary, both round trips of the scheme-2 demo, every digit
of scheme2_add's add, mul, sub_wide and min_max, and, in a gloo world of
one process, every gate of the scaling harness and every digit and carry
of scheme2_dist's tensor-parallel add."""

import pytest

torch = pytest.importorskip("torch")
# The twins issue many small ops: one thread each, or the parallel test
# workers oversubscribe the cores and run many times slower.
torch.set_num_threads(1)

from sgfhe_tpu_torch import examples  # noqa: E402
import torch.distributed as dist  # noqa: E402

from sgfhe_tpu_torch.examples import (adder, depth, errors, scaling, scheme2_add,  # noqa: E402
                                      scheme2_demo, scheme2_dist)
from sgfhe_tpu_torch.parallel import distributed as pdist  # noqa: E402


def test_parse_takes_positionals_device_and_flags():
    assert examples.parse(["3", "--device", "cpu", "--bkey"], (1, 1024), ("--bkey",)) == \
        ((3, 1024), "cpu", {"--bkey"})
    assert examples.parse([], (8, 64, 4)) == ((8, 64, 4), "cuda", set())
    with pytest.raises(SystemExit):
        examples.parse(["1", "2", "3"], (1, 2))
    with pytest.raises(SystemExit):
        examples.parse(["--fast"], (1,))


def test_adder(capsys):
    out = adder.main(["2", "64", "2", "--device", "cpu"])
    text = capsys.readouterr().out
    assert "PASS" in text and "WRONG" not in text
    assert [f"{a} + {b} = {a + b}  [ok]" in text for a, b in out["pairs"]] == [True, True]


def test_depth(capsys):
    out = depth.main(["2", "64", "--device", "cpu"])
    assert out["generations"] == 2 and out["max_err"] < 64
    assert "PASS: 2 chained generations x 32 gates" in capsys.readouterr().out


def test_errors(capsys):
    out = errors.main(["64", "1", "--device", "cpu"])
    assert out["report"]["ok"] and max(out["encrypt"], out["bootstrap"], out["pack"]) < 128
    assert "bootstrap noise report:" in capsys.readouterr().out


def test_scheme2_demo(capsys):
    out = scheme2_demo.main(["2", "64", "--bkey", "--device", "cpu"])
    p = out["params"]
    assert out["bkey_shape"] == (p.n, 2 * p.num_digits, 2, p.num_limbs, p.m)
    text = capsys.readouterr().out
    assert "private k-bit roundtrip ok" in text and "public k-bit roundtrip ok" in text


def test_scheme2_add(capsys, monkeypatch):
    monkeypatch.setattr(scheme2_add, "ITERS", 1)  # one timed call a stage
    rates = scheme2_add.main(["1", "2", "64", "--device", "cpu"])
    assert set(rates) == {"adds", "muls", "subs", "min_max"}
    text = capsys.readouterr().out
    for what in ("(digit+carry verified)", "(lo+hi digits verified)",
                 "(diff + [x>=y] flag verified)", "(both extrema verified)"):
        assert what in text


@pytest.fixture
def world1(tmp_path):
    """A gloo world of this process alone, joined by a file (the examples
    use the world they find)."""
    pdist.initialize(f"file://{tmp_path / 'pg'}", 1, 0, device="cpu")
    yield
    dist.destroy_process_group()


def test_scaling(world1, capsys, monkeypatch):
    monkeypatch.setattr(scaling, "ITERS", 1)  # one timed call
    rows = scaling.main(["6", "64", "--device", "cpu"])
    assert [(nd, eff) for nd, _, eff in rows] == [(1, 1.0)] and rows[0][1] > 0
    text = capsys.readouterr().out
    assert "devices=1:" in text and "PASS: 6 gates on the 1-rank mesh" in text


def test_scheme2_dist(world1, capsys):
    out = scheme2_dist.main(["1", "2", "0", "64", "--device", "cpu"])
    assert out["key_dist"].shape[-2:] == (4, 128)
    assert "PASS k=1 dist (tp=1, prune=0): digit+carry decrypt-verified on 2 adds" in \
        capsys.readouterr().out
