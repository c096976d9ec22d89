"""The rotation kernels' launch plans (sgfhe_tpu_torch/ops/fused.py): what
csrc/rotate.cu is launched with, checked on the CPU for every supported
shape."""

import itertools

import pytest

torch = pytest.importorskip("torch")

from sgfhe_tpu_torch.ops import fused  # noqa: E402

MS = (512, 1024, 2048, 4096, 8192, 16384, 32768)
BATCHES = (1, 2, 7, 64, 255, 256, 1000, 4096)


def _shapes():
    for L, m, B in itertools.product((2, 3, 4), MS, BATCHES):
        for prune in range(L):
            yield B, L, m, prune


def test_plans_fit_shared_memory():
    for B, L, m, prune in _shapes():
        for plan in (fused.fwd_plan(B, L, m, prune), fused.mac_plan(B, L, m, prune)):
            assert 0 < plan.smem <= fused.SMEM_BLOCK, (B, L, m, prune, plan)
            assert plan.per_sm >= 1 and plan.threads % 32 == 0


def test_fwd_plan_covers_every_polynomial_once():
    """Blocks x (limbs, digits) per block = every (gate, operand, kept digit,
    limb) once; all digits of all limbs in one block where they fit."""
    for B, L, m, prune in _shapes():
        plan = fused.fwd_plan(B, L, m, prune)
        lk = L - prune
        assert L % plan.limbs == 0 and lk % plan.digits == 0
        assert plan.grid * plan.limbs * plan.digits == B * 2 * lk * L
        if fused.fwd_smem(L, lk, m) <= fused.SMEM_BLOCK:
            assert (plan.limbs, plan.digits) == (L, lk)


def test_mac_plan_tiles_cover_every_gate_once():
    for B, L, m, prune in _shapes():
        plan = fused.mac_plan(B, L, m, prune)
        tiles = plan.grid // (2 * L)
        assert plan.grid == 2 * L * tiles
        covered = [b for t in range(tiles)
                   for b in range(t * plan.gates, min(B, (t + 1) * plan.gates))]
        assert covered == list(range(B))
        assert m % plan.chunk == 0 and plan.chunk % 4 == 0


def test_mac_plan_fills_the_last_wave_at_params_512():
    """Params(512): B = 256, L = 3, m = 4096 on 132 SMs. A 1,536-block grid
    of 256-thread blocks left its second wave less than half full."""
    plan = fused.mac_plan(256, 3, 4096, 0, 132)
    assert plan.last_wave_fill >= 0.5, plan
    assert plan.gates > 1  # the key chunk serves several gates


def test_envelope_refused_with_its_limit():
    """m = 65536 (scheme 1 at n = 8192) does not fit one block's NTT: the
    plans, which the wrappers consult before every launch, refuse it by
    name, with the bound on m and no scheme's bound on n."""
    for plan in (fused.fwd_plan, fused.mac_plan):
        with pytest.raises(ValueError, match=r"m = 65536 exceeds .* m <= 32768:") as err:
            plan(4, 3, 65536, 0)
        assert "n <=" not in str(err.value)
