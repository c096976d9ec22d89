"""Boolean-circuit evaluation on encrypted bits, the framework layer above
the gate bootstrap (counterpart of sgfhe_tpu/circuit.py).

The builder (`Circuit`, the stock circuits and `evaluate_plain`) is a copy
of the JAX package's pure-Python one and must equal it wire for wire and
level for level (tests/test_torch_circuit.py). It schedules a circuit so
that:

 - gates are grouped into topological levels and each level runs as one
   batched gate bootstrap;
 - AND, OR and XOR of the same input pair share one bootstrap (one blind
   rotation yields all three, reference src/fhe.jl:585-593);
 - NOT, NAND, NOR and XNOR are free: LWE negation (a, b) -> (-a, Dr - b)
   maps the noise w to -w without growth;
 - constants fold at build time, so no bootstrap is spent on a known value;
 - the circuit is SIMD over a leading instance axis: B instances cost the
   launches of one, with B multiplying each level's batch.

Randomized mode: `evaluate` folds a fresh epoch into its two seed words
(ops/prg.fold_epoch) and splits the folded words into one pair per level
(ops/prg.split_words); `evaluate_internal` takes the levels' pairs as
given and agrees with the JAX package bit for bit on its words.

    c = Circuit()
    a = [c.input() for _ in range(8)]; b = [c.input() for _ in range(8)]
    carry = c.const(0)
    for i in range(8):
        axb, aab = c.xor_(a[i], b[i]), c.and_(a[i], b[i])   # one bootstrap
        c.output(c.xor_(axb, carry))                        # one bootstrap
        carry = c.or_(aab, c.and_(axb, carry))              # (same pair) + one
    c.output(carry)
    outs = evaluate(c, params, ctx, bkey, encrypted_inputs)
"""

from __future__ import annotations

import dataclasses

import torch

from .models import bootstrap as bs
from .models.scheme1 import LWE, EncryptedBit
from .ops import prg
from .utils import profiling

# wire sources
_INPUT = "input"
_CONST = "const"
_NOT = "not"
_GATES = ("and", "or", "xor")


@dataclasses.dataclass
class _Wire:
    op: str            # 'input' | 'const' | 'not' | 'and' | 'or' | 'xor'
    args: tuple        # input: (index,); const: (0|1,); not: (wire,);
    #                    gates: (wire_x, wire_y) with wire_x <= wire_y
    level: int         # 0 for inputs/consts; gates bump by one


class Circuit:
    """Builder for a boolean circuit over encrypted bits.

    Wires are integer handles. Gate methods return wires; `output` marks
    wires whose ciphertexts `evaluate` returns (in call order). The builder
    folds constants and simplifies same-wire gates, so the bootstrap count
    reflects only work that needs the key.
    """

    def __init__(self):
        self._wires: list[_Wire] = []
        self._num_inputs = 0
        self._outputs: list[int] = []
        # structural dedup: identical nodes map to one wire
        self._cse: dict[tuple, int] = {}

    # -- construction -------------------------------------------------------

    def input(self) -> int:
        idx = self._num_inputs
        self._num_inputs += 1
        return self._add(_INPUT, (idx,), 0)

    def const(self, value: int) -> int:
        return self._add(_CONST, (int(bool(value)),), 0)

    def not_(self, x: int) -> int:
        w = self._wires[x]
        if w.op == _CONST:
            return self.const(1 - w.args[0])
        if w.op == _NOT:  # double negation
            return w.args[0]
        return self._add(_NOT, (x,), w.level)

    def and_(self, x: int, y: int) -> int:
        return self._gate("and", x, y)

    def or_(self, x: int, y: int) -> int:
        return self._gate("or", x, y)

    def xor_(self, x: int, y: int) -> int:
        return self._gate("xor", x, y)

    def nand(self, x: int, y: int) -> int:
        return self.not_(self.and_(x, y))

    def nor(self, x: int, y: int) -> int:
        return self.not_(self.or_(x, y))

    def xnor(self, x: int, y: int) -> int:
        return self.not_(self.xor_(x, y))

    def output(self, x: int) -> None:
        self._outputs.append(x)

    # -- internals ----------------------------------------------------------

    def _add(self, op: str, args: tuple, level: int) -> int:
        key = (op, args)
        if key in self._cse and op != _INPUT:
            return self._cse[key]
        self._wires.append(_Wire(op, args, level))
        idx = len(self._wires) - 1
        if op != _INPUT:
            self._cse[key] = idx
        return idx

    def _const_of(self, x: int) -> int | None:
        w = self._wires[x]
        return w.args[0] if w.op == _CONST else None

    def _gate(self, op: str, x: int, y: int) -> int:
        cx, cy = self._const_of(x), self._const_of(y)
        # constant folding (both orders)
        if cx is not None and cy is not None:
            v = {"and": cx & cy, "or": cx | cy, "xor": cx ^ cy}[op]
            return self.const(v)
        if cx is not None:
            x, y, cx, cy = y, x, cy, cx
        if cy is not None:
            if op == "and":
                return x if cy else self.const(0)
            if op == "or":
                return self.const(1) if cy else x
            return self.not_(x) if cy else x  # xor
        # same-wire simplification
        if x == y:
            return x if op in ("and", "or") else self.const(0)
        nx = self._wires[x].op == _NOT and self._wires[x].args[0] == y
        ny = self._wires[y].op == _NOT and self._wires[y].args[0] == x
        if nx or ny:  # x = NOT y (or vice versa)
            if op == "and":
                return self.const(0)
            return self.const(1)  # or / xor of complementary wires
        if x > y:
            x, y = y, x
        lvl = max(self._wires[x].level, self._wires[y].level) + 1
        return self._add(op, (x, y), lvl)

    # -- compiled structure --------------------------------------------------

    @property
    def depth(self) -> int:
        """Multiplicative (bootstrap) depth of the circuit."""
        return max((w.level for w in self._wires), default=0)

    @property
    def num_inputs(self) -> int:
        return self._num_inputs

    @property
    def num_outputs(self) -> int:
        return len(self._outputs)

    def schedule(self) -> list[list[tuple[int, int]]]:
        """Bootstrap jobs per level: level k (1-based) holds the unique
        (wire_x, wire_y) pairs whose gates sit at that level. Only wires
        reachable from outputs are scheduled (dead gates cost nothing)."""
        live = set()
        stack = list(self._outputs)
        while stack:
            i = stack.pop()
            if i in live:
                continue
            live.add(i)
            w = self._wires[i]
            if w.op == _NOT:
                stack.append(w.args[0])
            elif w.op in _GATES:
                stack.extend(w.args)
        levels: dict[int, list[tuple[int, int]]] = {}
        seen: set[tuple[int, tuple[int, int]]] = set()
        for i in sorted(live):
            w = self._wires[i]
            if w.op in _GATES and (w.level, w.args) not in seen:
                seen.add((w.level, w.args))
                levels.setdefault(w.level, []).append(w.args)
        return [levels.get(k, []) for k in range(1, self.depth + 1)]

    @property
    def num_bootstraps(self) -> int:
        """Blind rotations per evaluation (after pair-sharing + folding)."""
        return sum(len(lv) for lv in self.schedule())


# ---------------------------------------------------------------------------
# Evaluation
# ---------------------------------------------------------------------------


def _neg_lwe(params, lwe: LWE) -> LWE:
    """NOT on the LWE encoding m*Dr + w: (a, b) -> (-a, Dr - b) mod r."""
    return LWE((-lwe.a) & params.mask_r, (params.Dr - lwe.b) & params.mask_r)


def _pad_rows(x: torch.Tensor, rows: int) -> torch.Tensor:
    return torch.cat([x, x.new_zeros((rows - x.shape[0],) + tuple(x.shape[1:]))])


def evaluate_internal(circuit: Circuit, params, ctx, bkey, inputs, level_seeds=None, *,
                      plain: bool = False) -> list[EncryptedBit]:
    """`evaluate` with each level's seed words given: level_seeds is None
    (deterministic) or one pair of Threefry key words for each level of
    `circuit.schedule()`, used as given."""
    with profiling.span("circuit"):
        if len(inputs) != circuit.num_inputs:
            raise ValueError(f"circuit has {circuit.num_inputs} inputs, got {len(inputs)}")
        n = params.n
        batched = None
        in_lwes = []
        for eb in inputs:
            a = eb.lwe.a
            is_b = a.ndim == 2
            if batched is None:
                batched = is_b
            elif batched != is_b:
                raise ValueError("all inputs must be uniformly batched or not")
            if is_b and a.shape[0] != inputs[0].lwe.a.shape[0]:
                raise ValueError("all batched inputs must share the batch size")
            in_lwes.append(LWE(a, eb.lwe.b) if is_b else LWE(a[None], torch.atleast_1d(eb.lwe.b)))
        B = in_lwes[0].a.shape[0] if in_lwes else 1
        dev = in_lwes[0].a.device if in_lwes else ctx.device

        values: dict[int, LWE] = {}

        def lwe_of(i: int) -> LWE:
            if i in values:
                return values[i]
            w = circuit._wires[i]
            if w.op == _INPUT:
                v = in_lwes[w.args[0]]
            elif w.op == _CONST:
                v = LWE(torch.zeros((B, n), dtype=torch.int64, device=dev),
                        torch.full((B,), w.args[0] * params.Dr, dtype=torch.int64, device=dev))
            elif w.op == _NOT:
                v = _neg_lwe(params, lwe_of(w.args[0]))
            else:
                raise RuntimeError(f"gate wire {i} not yet materialized (level ordering bug)")
            values[i] = v
            return v

        schedule = circuit.schedule()
        if level_seeds is not None and len(level_seeds) != len(schedule):
            raise ValueError(f"{len(schedule)} levels, {len(level_seeds)} seed-word pairs")
        # gates of the live set, grouped by (level, pair) for scatter
        gate_index: dict[tuple[int, int], dict[str, int]] = {}
        for i, w in enumerate(circuit._wires):
            if w.op in _GATES:
                gate_index.setdefault(w.args, {})[w.op] = i

        for lvl, pairs in enumerate(schedule):
            if not pairs:
                continue
            with profiling.span("circuit.level"):
                a1 = torch.cat([lwe_of(x).a for x, _ in pairs])
                b1 = torch.cat([lwe_of(x).b for x, _ in pairs])
                a2 = torch.cat([lwe_of(y).a for _, y in pairs])
                b2 = torch.cat([lwe_of(y).b for _, y in pairs])
                # pad the level's batch to a power of two with zero LWEs, as the
                # JAX package does (there to bound its compiles); the padded lanes
                # come after every real one, whose masks count gates by global
                # index, so they change no real output
                width = a1.shape[0]
                pw = 1 << (width - 1).bit_length()
                if pw != width:
                    a1, b1, a2, b2 = (_pad_rows(x, pw) for x in (a1, b1, a2, b2))
                seed2 = level_seeds[lvl] if level_seeds is not None else None
                triple = bs.bootstrap_internal(params, ctx, bkey.hat, bkey.hat_shoup,
                                               a1, b1, a2, b2, seed2, plain=plain)
                by_op = dict(zip(_GATES, (bs._reduce_lwe(params, ctx, t) for t in triple)))
                for j, pair in enumerate(pairs):
                    sl = slice(j * B, (j + 1) * B)
                    for op, wire in gate_index.get(pair, {}).items():
                        if circuit._wires[wire].level == lvl + 1:
                            out = by_op[op]
                            values[wire] = LWE(out.a[sl], out.b[sl])

        outs = []
        for i in circuit._outputs:
            v = lwe_of(i)
            outs.append(EncryptedBit(v if batched else LWE(v.a[0], v.b[0])))
        return outs


def evaluate(circuit: Circuit, params, ctx, bkey, inputs, seed_words=None,
             epoch: "int | None" = None, *, plain: bool = False) -> list[EncryptedBit]:
    """Evaluate `circuit` on encrypted inputs; returns the output
    EncryptedBits in `output()` order.

    inputs: one EncryptedBit per circuit input, each a single bit (lwe.a of
    shape (n,)) or a SIMD batch ((B, n), the same B for all), in which case
    the circuit runs on B instances at once. Each level is one batched gate
    bootstrap (one launch on the card for a key of at most 10 MiB, 2n
    above that).

    seed_words: None (deterministic) or two uint32 words for randomized
    flattening; a fresh epoch is folded in per call (pin it with `epoch`)
    and the folded words are split into one pair per level."""
    seed2 = prg.fold_epoch(seed_words, epoch)
    levels = len(circuit.schedule())
    level_seeds = None if seed2 is None else prg.split_words(seed2, levels)
    return evaluate_internal(circuit, params, ctx, bkey, inputs, level_seeds, plain=plain)


def evaluate_plain(circuit: Circuit, bits) -> list[int]:
    """Plaintext oracle: evaluate the circuit on Python ints (0/1)."""
    if len(bits) != circuit.num_inputs:
        raise ValueError("input count mismatch")
    vals: dict[int, int] = {}

    def val(i: int) -> int:
        if i in vals:
            return vals[i]
        w = circuit._wires[i]
        if w.op == _INPUT:
            v = int(bits[w.args[0]]) & 1
        elif w.op == _CONST:
            v = w.args[0]
        elif w.op == _NOT:
            v = 1 - val(w.args[0])
        else:
            x, y = (val(a) for a in w.args)
            v = {"and": x & y, "or": x | y, "xor": x ^ y}[w.op]
        vals[i] = v
        return v

    return [val(i) for i in circuit._outputs]


# ---------------------------------------------------------------------------
# Stock circuits
# ---------------------------------------------------------------------------


def ripple_adder(nbits: int) -> Circuit:
    """nbits-bit ripple-carry adder: inputs a_0..a_{nbits-1}, b_0.. (LSB
    first); outputs sum_0..sum_{nbits-1}, carry_out. Costs 3 bootstraps per
    full adder (XOR/AND pair sharing), 1 for the half adder at bit 0."""
    c = Circuit()
    a = [c.input() for _ in range(nbits)]
    b = [c.input() for _ in range(nbits)]
    carry = c.const(0)
    for i in range(nbits):
        axb = c.xor_(a[i], b[i])
        aab = c.and_(a[i], b[i])        # shares the (a, b) bootstrap
        c.output(c.xor_(axb, carry))
        carry = c.or_(aab, c.and_(axb, carry))  # shares the (axb, carry) one
    c.output(carry)
    return c


def equality(nbits: int) -> Circuit:
    """a == b over nbits-bit inputs: XNOR per bit, AND-tree reduction."""
    c = Circuit()
    a = [c.input() for _ in range(nbits)]
    b = [c.input() for _ in range(nbits)]
    eq = [c.xnor(x, y) for x, y in zip(a, b)]
    while len(eq) > 1:
        nxt = [c.and_(eq[i], eq[i + 1]) for i in range(0, len(eq) - 1, 2)]
        if len(eq) % 2:
            nxt.append(eq[-1])
        eq = nxt
    c.output(eq[0])
    return c


def subtractor(nbits: int) -> Circuit:
    """nbits-bit ripple-borrow subtractor a - b (LSB first): outputs
    diff_0..diff_{nbits-1}, no_borrow (1 iff a >= b). Two's complement:
    a + NOT(b) + 1, with NOT free (linear) and the +1 as carry-in."""
    c = Circuit()
    a = [c.input() for _ in range(nbits)]
    b = [c.input() for _ in range(nbits)]
    carry = c.const(1)
    for i in range(nbits):
        nb = c.not_(b[i])
        axb = c.xor_(a[i], nb)
        aab = c.and_(a[i], nb)
        c.output(c.xor_(axb, carry))
        carry = c.or_(aab, c.and_(axb, carry))
    c.output(carry)
    return c


def comparator(nbits: int) -> Circuit:
    """a vs b over nbits-bit inputs: outputs (a >= b, a == b). The >= flag
    is the subtractor's no-borrow carry with the diff outputs pruned; == is
    an XNOR AND-tree sharing the per-bit bootstraps."""
    c = Circuit()
    a = [c.input() for _ in range(nbits)]
    b = [c.input() for _ in range(nbits)]
    carry = c.const(1)
    eq = []
    for i in range(nbits):
        nb = c.not_(b[i])
        axb = c.xor_(a[i], nb)          # == XNOR(a_i, b_i): reused for ==
        aab = c.and_(a[i], nb)
        carry = c.or_(aab, c.and_(axb, carry))
        eq.append(axb)
    while len(eq) > 1:
        nxt = [c.and_(eq[i], eq[i + 1]) for i in range(0, len(eq) - 1, 2)]
        if len(eq) % 2:
            nxt.append(eq[-1])
        eq = nxt
    c.output(carry)
    c.output(eq[0])
    return c


def mux(nbits: int) -> Circuit:
    """2-to-1 multiplexer: inputs sel, a_0.., b_0..; outputs a if sel else b,
    per bit: (sel AND a) OR (NOT sel AND b)."""
    c = Circuit()
    sel = c.input()
    a = [c.input() for _ in range(nbits)]
    b = [c.input() for _ in range(nbits)]
    nsel = c.not_(sel)
    for i in range(nbits):
        c.output(c.or_(c.and_(sel, a[i]), c.and_(nsel, b[i])))
    return c
