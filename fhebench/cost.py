"""The blind rotation's least time on one H100: its work, counted from its
shapes whatever kernels implement it.

The multiply counts are frozen copies of `fwd_cost`, `mac_cost` and
`resident_cost` in chip_smoke.py at the commit that added this benchmark:
a step of the algorithm is the digit chain (and in randomized mode the
masks) once per coefficient, one forward NTT per (lane, operand, kept
digit, limb), the gadget MAC, the x^u multiply and the inverse NTT of both
columns, each modular multiply three int32 multiplies (Shoup). The MAC's
T-term is the work the inputs need: with every digit kept (prune 0) the
T of a step is carried from the hat of the entry accumulators, as both
`rotate_resident` and the step pair's carry mode compute it (t_mode 2: no
multiply an element for it, one forward NTT of the entry accumulators a
rotation); with digits pruned it takes lk w-multiplies an element (t_mode
0). The bytes are what one rotation has to move at least: the key's hat
rows of the kept digits read once (not their Shoup companions, which no
kernel reads), the two accumulators read once and written once, and the
exponents. Not counted: the step pair's `d_hat` round trip through device
memory, or any re-read. A later algorithm that needs fewer multiplies (an
NTT on tensor cores) needs a change of this count, in a benchmark PR.
"""

from __future__ import annotations

#: H100 SXM HBM3 bandwidth (NVIDIA's data sheet).
HBM_BYTES_PER_S = 3.35e12
#: int32 multiplies a second, derived, not published: the data sheet's 67
#: TFLOP/s float32 counts an FMA as 2 operations on 128 lanes an SM;
#: Hopper has 64 int32 multiply lanes an SM, so a quarter of that rate.
INT32_MUL_PER_S = 67e12 / 4
#: int32 multiplies of one Shoup modular multiply: a*w, mulhi(a, w'), q*p.
SHOUP_MULS = 3


def forward_muls(B: int, L: int, m: int, lk: int, randomized: bool) -> int:
    """int32 multiplies of one step's flatten and forward NTTs over B lanes
    (chip_smoke.fwd_cost)."""
    logm = m.bit_length() - 1
    coeffs = 2 * B * m
    chain = L * (L - 1) // 2 * SHOUP_MULS  # digit d takes d Shoup steps
    masks = lk * L * (1 + SHOUP_MULS) if randomized else 0  # v % p_j, times w
    ntt = B * 2 * lk * L * (m // 2) * logm * SHOUP_MULS
    return coeffs * (chain + masks) + ntt


def mac_muls(B: int, L: int, m: int, lk: int, carried: bool) -> int:
    """int32 multiplies of one step's MAC, x^u and inverse NTTs over B
    lanes, the T-term carried or by w-multiplies (chip_smoke.mac_cost,
    t_mode 2 or 0)."""
    logm = m.bit_length() - 1
    per_elem = 2 * lk + (0 if carried else lk) + 1 + 1
    return 2 * B * L * (m * per_elem + (m // 2) * logm) * SHOUP_MULS


def entry_muls(B: int, L: int, m: int) -> int:
    """int32 multiplies of the forward NTT of the entry accumulators (both
    columns) that a carried T starts from (chip_smoke.resident_cost)."""
    logm = m.bit_length() - 1
    return B * 2 * L * (m // 2) * logm * SHOUP_MULS


def rotation_bytes(B: int, L: int, m: int, n: int, lk: int) -> int:
    """Bytes one rotation of B lanes moves at least: the key's kept hat rows
    (n, 2 lk, 2, L, m) uint32 once, the accumulators (2, B, L, m) uint32
    read and written once, the exponents (B, n) int32."""
    key = n * 2 * lk * 2 * L * m * 4
    acc = 2 * 2 * B * L * m * 4
    return key + acc + B * n * 4


def rotation_muls(B: int, L: int, m: int, n: int, l: int, lk: int,
                  randomized: bool) -> int:
    """int32 multiplies of one rotation of B lanes with lk of the key's l
    digits kept: n steps, and the entry NTT where T is carried (lk == l)."""
    carried = lk == l
    steps = n * (forward_muls(B, L, m, lk, randomized) + mac_muls(B, L, m, lk, carried))
    return steps + (entry_muls(B, L, m) if carried else 0)


def least_seconds(B: int, L: int, m: int, n: int, l: int, lk: int,
                  randomized: bool) -> float:
    """The larger of bytes over HBM bandwidth and multiplies over the int32
    multiply rate."""
    return max(rotation_bytes(B, L, m, n, lk) / HBM_BYTES_PER_S,
               rotation_muls(B, L, m, n, l, lk, randomized) / INT32_MUL_PER_S)
