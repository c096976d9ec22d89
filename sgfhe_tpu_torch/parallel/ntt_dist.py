"""Distributed four-step negacyclic NTT over the 'tp' mesh axis
(counterpart of sgfhe_tpu/parallel/ntt_dist.py), on `torch.distributed`.

When one transform of length m = m1*m2 spans ranks, each rank holds a
column slice, does a local length-m1 transform, applies the inter-stage
twiddles, exchanges blocks by `all_to_all_single` over the tp group, and
finishes with a local length-m2 transform: the Bailey decomposition with
the sub-transforms' bit-reversed ordering folded into precomputed
twiddle matrices.

Layout contract: coefficient-domain input is (..., L, m1, m2) with the
LAST axis split over 'tp' (rank i holds columns [i*m2/D, (i+1)*m2/D));
hat-domain output is (..., L, m1, m2) with the m1 (pos1) axis split. Forward
then inverse returns the input layout, and two forward outputs multiply
pointwise (the global position permutation k = br1(pos1) + m1*br2(pos2)
is consistent). A rank's column slice of a table takes the place of the
JAX package's `dynamic_slice`. Tables are int64 tensors, as in
ops/ntt.py; the exchanges move int64.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.distributed as dist

from ..ops import modmath as mm
from ..ops import ntt as ntt_mod
from ..utils import primes as pr


@dataclasses.dataclass(frozen=True)
class DistNttPlan:
    plan1: ntt_mod.NttPlan   # cyclic, length m1
    plan2: ntt_mod.NttPlan   # cyclic, length m2
    tw: torch.Tensor         # (L, m1, m2): ω^{br1(pos1)·i2}
    tw_s: torch.Tensor
    tw_inv: torch.Tensor     # (L, m1, m2): ω^{-br1(pos1)·i2}
    tw_inv_s: torch.Tensor
    pre: torch.Tensor        # (L, m1, m2): ψ^{i1·m2+i2}
    pre_s: torch.Tensor
    post: torch.Tensor       # (L, m1, m2): ψ^{-(i1·m2+i2)}
    post_s: torch.Tensor


def build_dist_plan(moduli: tuple[int, ...], m1: int, m2: int, device) -> DistNttPlan:
    """The four-step tables by the JAX package's host loops (exact
    Python-int arithmetic) with their Shoup companions, moved to `device`."""
    moduli = tuple(int(p) for p in moduli)
    m = m1 * m2
    L = len(moduli)
    br1 = ntt_mod._bit_reverse_indices(m1)
    tw = np.zeros((L, m1, m2), dtype=np.uint64)
    twi = np.zeros((L, m1, m2), dtype=np.uint64)
    pre = np.zeros((L, m1, m2), dtype=np.uint64)
    post = np.zeros((L, m1, m2), dtype=np.uint64)
    for li, p in enumerate(moduli):
        assert (p - 1) % (2 * m) == 0
        psi = pr.root_of_unity(2 * m, p)
        omega = psi * psi % p
        inv_omega = pr.inv_mod(omega, p)
        inv_psi = pr.inv_mod(psi, p)
        for pos1 in range(m1):
            k1 = int(br1[pos1])
            wrow = pow(omega, k1, p)
            wirow = pow(inv_omega, k1, p)
            cur, curi = 1, 1
            for i2 in range(m2):
                tw[li, pos1, i2] = cur
                twi[li, pos1, i2] = curi
                cur = cur * wrow % p
                curi = curi * wirow % p
        for i1 in range(m1):
            for i2 in range(m2):
                e = i1 * m2 + i2
                pre[li, i1, i2] = pow(psi, e, p)
                post[li, i1, i2] = pow(inv_psi, e, p)
    tables = {}
    for name, v in (("tw", tw), ("tw_inv", twi), ("pre", pre), ("post", post)):
        tables[name] = torch.as_tensor(v.astype(np.int64), device=device)
        tables[name + "_s"] = torch.as_tensor(
            ntt_mod._shoup_table(v, moduli).astype(np.int64), device=device)
    return DistNttPlan(
        plan1=ntt_mod.build_plan(moduli, m1, device, negacyclic=False),
        plan2=ntt_mod.build_plan(moduli, m2, device, negacyclic=False),
        **tables,
    )


def _ntt_axis(plan, x, inverse: bool):
    """Transform axis -2 of (..., L, t, rest): move `rest` before the limbs,
    transform the last axis, move it back."""
    xt = x.movedim(-1, -3)  # (..., rest, L, t)
    yt = ntt_mod.ntt_inv(plan, xt) if inverse else ntt_mod.ntt_fwd(plan, xt)
    return yt.movedim(-3, -1)


def fwd_finish(plan: DistNttPlan, x: torch.Tensor) -> torch.Tensor:
    """After the exchange: x (..., L, m1_loc, m2) -> transform the m2 axis."""
    return ntt_mod.ntt_fwd(plan.plan2, x.movedim(-2, -3)).movedim(-3, -2)


def inv_start(plan: DistNttPlan, x: torch.Tensor) -> torch.Tensor:
    return ntt_mod.ntt_inv(plan.plan2, x.movedim(-2, -3)).movedim(-3, -2)


def _cols(tbl, idx, m2_loc):
    return tbl[..., idx * m2_loc:(idx + 1) * m2_loc]


def fwd_local_dyn(plan: DistNttPlan, x, idx: int, m2_loc: int):
    """Before the exchange, on rank idx's column slice x (..., L, m1, m2_loc):
    ψ pre-twist, length-m1 transform, inter-stage twiddles."""
    p = plan.plan1.p[..., None]
    x = mm.shoup_mul(x, _cols(plan.pre, idx, m2_loc), _cols(plan.pre_s, idx, m2_loc), p)
    x = _ntt_axis(plan.plan1, x, inverse=False)
    return mm.shoup_mul(x, _cols(plan.tw, idx, m2_loc), _cols(plan.tw_s, idx, m2_loc), p)


def inv_finish_dyn(plan: DistNttPlan, x, idx: int, m2_loc: int):
    """After the inverse exchange, on rank idx's column slice: inverse
    twiddles, inverse length-m1 transform, ψ^{-1} post-twist."""
    p = plan.plan1.p[..., None]
    x = mm.shoup_mul(x, _cols(plan.tw_inv, idx, m2_loc), _cols(plan.tw_inv_s, idx, m2_loc), p)
    x = _ntt_axis(plan.plan1, x, inverse=True)
    return mm.shoup_mul(x, _cols(plan.post, idx, m2_loc), _cols(plan.post_s, idx, m2_loc), p)


def exchange_to_rows(x: torch.Tensor, group, D: int) -> torch.Tensor:
    """The forward exchange: column slice (..., m1, m2/D) -> row slice
    (..., m1/D, m2). The split axis goes to the front, contiguous, for
    `all_to_all_single`; chunk j (rows j*m1/D...) goes to rank j."""
    lead, (m1, m2l) = x.shape[:-2], x.shape[-2:]
    xs = x.reshape(lead + (D, m1 // D, m2l)).movedim(-3, 0).contiguous()
    out = torch.empty_like(xs)
    dist.all_to_all_single(out, xs, group=group)
    return out.movedim(0, -2).reshape(lead + (m1 // D, D * m2l))


def exchange_to_cols(x: torch.Tensor, group, D: int) -> torch.Tensor:
    """The inverse exchange: row slice (..., m1/D, m2) -> column slice
    (..., m1, m2/D)."""
    lead, (m1l, m2) = x.shape[:-2], x.shape[-2:]
    xs = x.reshape(lead + (m1l, D, m2 // D)).movedim(-2, 0).contiguous()
    out = torch.empty_like(xs)
    dist.all_to_all_single(out, xs, group=group)
    return out.movedim(0, -3).reshape(lead + (D * m1l, m2 // D))


def gather_cols(x: torch.Tensor, group, D: int) -> torch.Tensor:
    """Every rank's column slice (..., m1, m2/D) -> the whole (..., m1, m2)."""
    x = x.contiguous()
    out = x.new_empty((D * x.shape[0],) + x.shape[1:])
    dist.all_gather_into_tensor(out, x, group=group)
    out = out.reshape((D,) + x.shape)
    return out.movedim(0, -2).reshape(x.shape[:-1] + (D * x.shape[-1],))


def make_dist_polymul(plan: DistNttPlan, mesh, axis: str = "tp"):
    """A negacyclic polymul over (..., L, m1, m2) tensors whose columns are
    split over the mesh's `axis`: every rank passes the whole operands,
    transforms its column slice (two all_to_alls a direction, six in all)
    and returns the whole product. A demonstration of the multi-card NTT."""
    group = mesh.get_group(axis)
    D = dist.get_world_size(group)
    idx = dist.get_rank(group)

    def run(a, b):
        m2 = plan.tw.shape[-1]
        m2_loc = m2 // D

        def fwd(x):
            x = fwd_local_dyn(plan, _cols(x, idx, m2_loc), idx, m2_loc)
            return fwd_finish(plan, exchange_to_rows(x, group, D))

        p1 = plan.plan1
        prod = mm.mulmod(fwd(a), fwd(b), p1.p[..., None])
        y = exchange_to_cols(inv_start(plan, prod), group, D)
        return gather_cols(inv_finish_dyn(plan, y, idx, m2_loc), group, D)

    return run
