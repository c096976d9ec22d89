"""The rotation's work count against a hand count at one small shape."""

from __future__ import annotations

import pytest

from fhebench import cost


def test_work_equals_a_hand_count():
    # B = 1 lane, L = 2 limbs, m = 4, n = 1 step, lk = 2 kept digits.
    # forward: 2*1*4 = 8 coefficients x a chain of 1 Shoup step (3 muls)
    # = 24, NTTs 1 lane x 2 operands x 2 digits x 2 limbs x 2 butterflies
    # x 2 stages x 3 = 96
    assert cost.forward_muls(1, 2, 4, 2, False) == 24 + 96
    # randomized: each coefficient also draws 2 digits x 2 limbs of masks
    # at 4 muls each = 16, x 8 coefficients
    assert cost.forward_muls(1, 2, 4, 2, True) == 24 + 96 + 128
    # MAC, T carried: 2 columns x 1 lane x 2 limbs x (4 coefficients x
    # (2*2 key + 1 + 1) + 2 x 2 butterflies) x 3 = 4 x 28 x 3; by
    # w-multiplies 2 more an element: 4 x 36 x 3
    assert cost.mac_muls(1, 2, 4, 2, True) == 336
    assert cost.mac_muls(1, 2, 4, 2, False) == 432
    # the carried T's entry NTT: 1 lane x 2 columns x 2 limbs x 2
    # butterflies x 2 stages x 3
    assert cost.entry_muls(1, 2, 4) == 48
    assert cost.rotation_muls(1, 2, 4, 1, 2, 2, False) == 120 + 336 + 48
    # one digit of two pruned: forward 24 + NTTs 48, MAC 4 x (4 x 5 + 4) x
    # 3 by w-multiplies, no entry NTT
    assert cost.rotation_muls(1, 2, 4, 1, 2, 1, False) == 24 + 48 + 288
    # key rows 1 x 4 x 2 x 2 x 4 x 4 bytes = 256, accumulators read and
    # written 2 x 2 x 1 x 2 x 4 x 4 = 128, exponents 4
    assert cost.rotation_bytes(1, 2, 4, 1, 2) == 388
    assert cost.least_seconds(1, 2, 4, 1, 2, 2, False) == max(388 / 3.35e12, 504 / 16.75e12)


def test_main_shapes_are_bound_by_multiplies():
    # Params(512), 256 gates: about 37.2 us of multiplies a step, T carried
    step = (cost.rotation_muls(256, 3, 4096, 1, 3, 3, False)
            - cost.entry_muls(256, 3, 4096)) / cost.INT32_MUL_PER_S
    assert 37e-6 < step < 37.5e-6
    entry = cost.entry_muls(256, 3, 4096) / cost.INT32_MUL_PER_S
    assert cost.least_seconds(256, 3, 4096, 512, 3, 3, False) == pytest.approx(
        512 * step + entry)
    assert cost.rotation_bytes(256, 3, 4096, 512, 3) / cost.HBM_BYTES_PER_S < 512 * step
