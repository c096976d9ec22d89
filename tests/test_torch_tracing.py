"""The port's own spans (sgfhe_tpu_torch/utils/profiling.py: `span`,
`spans`, `on_trace_clock`) on the CPU, at Params(64) and scheme 2 at k = 1,
n = 64: each entry's spans nest as the layers do; the record lies on the
exported Chrome trace's clock, span for span; with no profiler the record
stays as it was, no clock is read and the answers are bit for bit those
of a traced call; and the record's window rules."""

import collections

import glob
import json
import time

import pytest

torch = pytest.importorskip("torch")
# The twins issue many small ops: one thread each, or the parallel test
# workers oversubscribe the cores and run many times slower.
torch.set_num_threads(1)
from torch.profiler import ProfilerActivity, profile, record_function  # noqa: E402

import sgfhe_tpu_torch as T  # noqa: E402
from sgfhe_tpu_torch import circuit as TC  # noqa: E402
from sgfhe_tpu_torch.utils import profiling as tprof  # noqa: E402

ENTRIES = ("gates", "digits", "circuit")
SEED_WORDS = (0x12345678, 0x9ABCDEF0)


def _circuit():
    """One level of three pairs, padded to four lanes."""
    c = TC.Circuit()
    a, b, x = c.input(), c.input(), c.input()
    for wire in (c.and_(a, b), c.xor_(a, x), c.or_(b, x)):
        c.output(wire)
    return c


@pytest.fixture(scope="module")
def calls():
    """Each entry as a function of no arguments: Params(64) gates on two
    lanes, exact; scheme 2 add_with_carry at k = 1 on two pairs (four
    lanes), randomized at prune 1; the circuit on one instance."""
    g = torch.Generator().manual_seed(21)
    params = T.Params.create(64)
    ctx = T.make_context(params, device="cpu")
    sk = T.PrivateKey.create(params, g, device="cpu")
    bk = T.BootstrapKey.create(ctx, sk, g)
    bits = T.split_ciphertext(T.encrypt(sk, g, torch.randint(0, 2, (params.n,), generator=g))).lwe
    lwe1, lwe2 = T.LWE(bits.a[0:4:2], bits.b[0:4:2]), T.LWE(bits.a[1:4:2], bits.b[1:4:2])
    ins = [T.EncryptedBit(T.LWE(bits.a[i:i + 1], bits.b[i:i + 1])) for i in range(3)]
    S2, B2 = T.Scheme2, T.Scheme2Boot
    p2 = S2.Params.create(1, 64)
    ctx2 = S2.make_context(p2, device="cpu")
    sk2 = S2.PrivateKey.create(p2, g, device="cpu")
    bk2 = S2.BootstrapKey.create(ctx2, sk2, g)
    digits = B2.split_ciphertext(p2, *S2.encrypt(sk2, g, torch.randint(0, 2, (p2.n,),
                                                                      generator=g)))
    x, y = T.LWE(digits.a[0:2], digits.b[0:2]), T.LWE(digits.a[2:4], digits.b[2:4])
    return {
        "gates": lambda: T.bootstrap_batch(params, ctx, bk.hat, bk.hat_shoup, lwe1, lwe2, epoch=1),
        "digits": lambda: B2.add_with_carry(p2, ctx2, bk2, x, y, None, SEED_WORDS, epoch=1,
                                            prune=1),
        "circuit": lambda: TC.evaluate(_circuit(), params, ctx, bk, ins, epoch=1),
    }


@pytest.fixture(scope="module")
def window(calls, tmp_path_factory):
    """One traced window (`profiling.trace`) of every entry, one request
    each, opened by a range of its own as a caller's step would be (so the
    profiler's set-up at its first event falls outside the program's
    spans): the record in the order the spans opened, each entry's spans
    (those inside its outermost span), the exported trace's user
    annotations, and each entry's answers."""
    path = tmp_path_factory.mktemp("trace")
    outs = {}
    with tprof.trace(str(path)):
        with record_function("test:window"):
            for name in ENTRIES:
                outs[name] = calls[name]()
    record = sorted(tprof.spans(), key=lambda e: e[1])
    (trace_file,) = glob.glob(str(path / "*.json"))
    roots = [e for e in record if e[0] in ENTRIES]
    assert [e[0] for e in roots] == list(ENTRIES)
    by_entry = {root[0]: [e for e in record if root[1] <= e[1] and e[2] <= root[2]]
                for root in roots}
    return record, by_entry, _annotations(trace_file), outs


def _annotations(trace_file):
    """The user annotations of an exported Chrome trace. The exporter writes
    one event a block opened by a line "  {"; a window of these calls holds
    about 300,000 CPU ops, so only the annotations' blocks are parsed."""
    with open(trace_file) as f:
        blocks = f.read().split("\n  {")
    events = [json.loads("{" + b[:b.rindex("}") + 1]) for b in blocks
              if '"user_annotation"' in b]
    assert events, "no user annotation in the exported trace"
    return events


def _flat(out):
    """An entry's answers as one list of tensors."""
    if isinstance(out, T.LWE):
        return [out.a, out.b]
    if isinstance(out, T.EncryptedBit):
        return _flat(out.lwe)
    return [t for o in out for t in _flat(o)]


def _expected_tree(name):
    """(span, parent span) of each span of the entry, in the order they
    open."""
    if name == "digits":
        return [("digits", None), ("bootstrap", "digits"), ("rotate", "bootstrap"),
                ("switch", "bootstrap"), ("switch", "bootstrap")]
    if name == "circuit":
        return [("circuit", None), ("circuit.level", "circuit"), ("bootstrap", "circuit.level"),
                ("rotate", "bootstrap")] + [("switch", "circuit.level")] * 6
    return [("gates", None), ("bootstrap", "gates"), ("rotate", "bootstrap")] + \
        [("switch", "gates")] * 6


def _parent(spans, e):
    """The innermost of `spans` that holds e (None: none does)."""
    holding = [p for p in spans if p is not e and p[1] <= e[1] and e[2] <= p[2]]
    return max(holding, key=lambda p: p[1])[0] if holding else None


@pytest.mark.parametrize("name", ENTRIES)
def test_spans_nest_as_the_layers(window, name):
    _, by_entry, _, _ = window
    spans = by_entry[name]
    assert all(e[1] <= e[2] for e in spans)
    assert [(e[0], _parent(spans, e)) for e in spans] == _expected_tree(name)


@pytest.mark.parametrize("name", ENTRIES)
def test_record_lies_on_the_chrome_traces_clock(window, name):
    """Each span, mapped by on_trace_clock, starts and ends within 100 us
    of its `sgfhe:` user annotation in the exported trace; a wrong base
    would be off by seconds."""
    record, by_entry, events, _ = window
    (opened,) = [e["ts"] * 1e-6 for e in events if e["name"] == "test:window"]
    ranges = sorted((e["ts"] * 1e-6, (e["ts"] + e["dur"]) * 1e-6, e["name"])
                    for e in events if e["name"].startswith("sgfhe:"))
    assert len(ranges) == len(record)
    mapped = tprof.on_trace_clock(record, opened)
    for e in by_entry[name]:
        i = record.index(e)
        start, end, label = ranges[i]
        assert label == "sgfhe:" + e[0]
        s, t = mapped[i]
        assert abs(s - start) < 100e-6 and abs(t - end) < 100e-6, (e[0], s - start, t - end)


@pytest.mark.parametrize("name", ENTRIES)
def test_untraced_call_records_nothing_and_answers_alike(window, calls, name, monkeypatch):
    monkeypatch.setattr(tprof, "_RECORD", collections.deque(maxlen=tprof.RECORD_CAP))
    out = calls[name]()
    assert tprof.spans() == []
    traced = window[3][name]
    got, want = _flat(out), _flat(traced)
    assert len(got) == len(want) > 0
    assert all(torch.equal(a, b) for a, b in zip(got, want))


def test_a_span_off_reads_no_clock_and_opens_no_range(monkeypatch):
    def fail(*_):
        raise AssertionError("an off span read the clock or opened a range")

    monkeypatch.setattr(tprof, "_RECORD", collections.deque(maxlen=tprof.RECORD_CAP))
    monkeypatch.setattr(tprof.time, "time_ns", fail)
    monkeypatch.setattr(tprof, "record_function", fail)
    with tprof.span("switch") as s:
        pass
    assert s is None and tprof.span("rotate") is tprof.span("switch")
    assert tprof.spans() == []


def test_trace_starts_the_record_anew(monkeypatch, tmp_path):
    """Each `trace()` window starts the record anew; reading keeps it; a
    profile opened directly adds to it; past the cap the oldest go."""
    monkeypatch.setattr(tprof, "_RECORD", collections.deque(maxlen=tprof.RECORD_CAP))
    for names in (("a", "b"), ("c",)):
        with tprof.trace(str(tmp_path)):
            for n in names:
                with tprof.span(n):
                    pass
        assert [e[0] for e in tprof.spans()] == list(names)
        assert [e[0] for e in tprof.spans()] == list(names)  # reading keeps it
    with profile(activities=[ProfilerActivity.CPU]):
        with tprof.span("d"):
            with tprof.span("e"):
                pass
    assert [e[0] for e in tprof.spans()] == ["c", "e", "d"]  # in the order they end
    monkeypatch.setattr(tprof, "_RECORD", collections.deque(maxlen=3))
    with profile(activities=[ProfilerActivity.CPU]):
        for n in "vwxyz":
            with tprof.span(n):
                pass
    assert [e[0] for e in tprof.spans()] == ["x", "y", "z"]


@pytest.mark.parametrize("offset_s", [0.0, 3.5e6, -3.5e6])
def test_on_trace_clock_takes_the_nearest_base(offset_s):
    """A record whose trace zero is k whole periods of libkineto's base:
    any time of the window within half a period gives the same seconds."""
    period = tprof.TRACE_BASE_PERIOD_S * 10**9
    base = (time.time_ns() // period) * period
    record = [("a", base + 5_000_000_123, base + 5_000_900_456),
              ("b", base + 5_000_100_000, base + 5_000_200_000)]
    got = tprof.on_trace_clock(record, 5.0 + offset_s)
    assert got == [(5.000000123, 5.000900456), (5.0001, 5.0002)]
    assert tprof.on_trace_clock([], 1.0) == []
