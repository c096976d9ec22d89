"""The blind rotation's CUDA kernels (csrc/rotate_resident.cu, csrc/rotate.cu),
their wrappers and their plain PyTorch versions.

Counterpart of sgfhe_tpu/ops/fused.py, whose two Pallas TPU kernels run all
n steps of a batch tile in one launch: `_rotate_kernel` (key resident in
VMEM, T-term carried) and `_rotate_step_kernel` (key streamed a step at a
time, T-term by w-multiplies).

  rotate_resident      `_rotate_kernel`'s counterpart, one launch for the
                       whole rotation (`blind_rotate_fused`): one block per
                       tile of G gates (`resident_plan`) loops over the n
                       steps with its gates' accumulators and digits in
                       shared memory and reads each step's key from L2. For
                       keys of at most 10 MiB with their companions
                       (models/bootstrap._RESIDENT_KEY_BYTES).

For larger keys one step is two CUDA launches and the n-step loop
(`blind_rotate_steps`) runs on the host:

  flatten_ntt_fwd      acc (2, B, L, m) -> d_hat (B, 2(l-prune), L, m):
                       balanced mixed-radix digits of both accumulators
                       (Threefry-masked in randomized mode), forward NTT.
  mac_rotate_ntt_inv   d_hat + key slice of step k -> new acc (2, B, L, m):
                       MAC against the key, T-term by w-multiplies (as the
                       streamed TPU kernel computes it), x^{u_k}, inverse
                       NTT.

Tensors the wrappers take and return are int32 holding uint32 bit patterns
(ops/modmath.py); their layouts are the kernels'. A wrapper launches its
kernel for CUDA tensors and runs its plain version, in int64, for CPU
tensors; any other device raises. Each wrapper counts its launches in its
`launches` attribute.

Every value the kernels keep is below 4p, and every value they write is
canonical, so the outputs equal the plain versions bit for bit. `_chk`
guards those bounds against the moduli in Python before each launch.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import numpy as np
import torch

from ..utils import primes as pr
from . import modmath as mm
from . import ntt as ntt_mod
from . import rns as rns_mod

_U32_LIMIT = (1 << 32) - 1
LMAX = 4  # csrc/rotate.cu RnsConsts
#: Largest lazy bound (in units of p) a kernel value reaches: the NTT
#: butterflies keep values below 4p.
KERNEL_LAZY_BOUND = 4


def _chk(c: int, p_max: int) -> int:
    """Static lazy-bound guard: a value bounded by c*p must fit uint32."""
    assert c * p_max <= _U32_LIMIT, (
        f"lazy-reduction bound overflow: {c} * p_max ({p_max}) exceeds "
        f"2^32 - 1; the reduction schedule must reset earlier"
    )
    return c


@dataclasses.dataclass(frozen=True)
class FusedTables:
    """What the kernels read besides their operands.

    tables (L, 10, m) int32 on the device, per limb:
      [0] fwd     merged forward twiddles: fwd[2^s + blk] = ψ^{F/2} of block
                  blk at stage s (the JAX package's fwd_full, one entry per
                  block instead of one per position)
      [1] fwd_s   Shoup companions
      [2] inv     inverse twiddles: inv[2^s + j] = the plan's inv_tw[s][j]
      [3] inv_s
      [4] post    ψ^{-i}·m^{-1}
      [5] post_s
      [6:8] pw    ψ^e for e in [0, 2m): x^u at hat position idx is one
                  gather of pw[(2*br(idx)+1)*u mod 2m]
      [8:10] pw_s
    consts: the RnsConsts words of csrc/rotate.cu as host uint32.
    """

    moduli: tuple
    m: int
    tables: torch.Tensor
    consts: np.ndarray
    close: bool


def build_tables_host(moduli: tuple[int, ...], m: int) -> np.ndarray:
    """The kernels' (L, 10, m) twiddle and power tables as numpy uint64."""
    L = len(moduli)
    S = m.bit_length() - 1
    h = ntt_mod.build_plan_host(moduli, m)
    out = np.zeros((L, 10, m), dtype=np.uint64)
    blocks = np.zeros((L, m), dtype=np.uint64)
    for li, p in enumerate(moduli):
        psi = pr.root_of_unity(2 * m, p)  # same root as build_plan
        # block z^blen - ψ^F splits into z^half - ψ^{F/2} (lo) and
        # z^half - ψ^{F/2+m} (hi); butterfly twiddle ψ^{F/2}
        F = [m]
        for s in range(S):
            for b, f in enumerate(F):
                blocks[li, (1 << s) + b] = pow(psi, f // 2, p)
            F = [e for f in F for e in (f // 2, (f // 2 + m) % (2 * m))]
    inv = np.zeros((L, m), dtype=np.uint64)
    for s in range(S):
        inv[:, (1 << s):(2 << s)] = h["inv"][s]
    mods = np.array(moduli, dtype=np.uint64).reshape(L, 1)

    def shoup(v):
        return (v << np.uint64(32)) // mods

    out[:, 0], out[:, 1] = blocks, shoup(blocks)
    out[:, 2], out[:, 3] = inv, shoup(inv)
    out[:, 4], out[:, 5] = h["post"], shoup(h["post"])
    out[:, 6:8] = h["psi_pow"].reshape(L, 2, m)
    out[:, 8:10] = shoup(h["psi_pow"]).reshape(L, 2, m)
    return out


def build_consts(moduli: tuple[int, ...]) -> np.ndarray:
    """csrc/rotate.cu's RnsConsts as a flat uint32 array."""
    L = len(moduli)
    assert L <= LMAX, f"the kernels take at most {LMAX} limbs, got {L}"
    t = rns_mod.build_context(moduli).tables()
    z1 = np.zeros(LMAX, dtype=np.uint64)

    def sq(a):  # (L, L[, 1]) -> (LMAX, LMAX)
        out = np.zeros((LMAX, LMAX), dtype=np.uint64)
        out[:L, :L] = np.asarray(a).reshape(L, L)
        return out

    def vec(a):
        out = z1.copy()
        out[:L] = np.asarray(a).reshape(L)
        return out

    kb = [rns_mod.mask_window_bits(p) for p in moduli]
    two_k = [[(1 << kb[i]) % q for q in moduli] for i in range(L)]
    kmask = [(1 << (kb[i] + 1)) - 1 for i in range(L)]
    parts = [
        vec(t["p"]), vec(t["offset"]),
        sq(t["inv_pj_val"]), sq(t["inv_pj_shoup"]),
        sq(t["s_mod"]), sq(t["w_val"]), sq(t["w_shoup"]),
        sq(two_k), vec(kmask),
    ]
    return np.concatenate([x.reshape(-1) for x in parts]).astype(np.uint32)


def build_fused(moduli: tuple[int, ...], m: int, device) -> FusedTables:
    moduli = tuple(int(p) for p in moduli)
    return FusedTables(
        moduli=moduli,
        m=m,
        tables=mm.bits32(torch.as_tensor(
            build_tables_host(moduli, m).astype(np.int64), device=device
        )),
        consts=build_consts(moduli),
        close=pr.close_primes(moduli),
    )


def fused_bkey_bytes(params) -> int:
    """Bytes of the bootstrap key with its Shoup companions."""
    n, l, L, m = params.n, params.num_digits, params.num_limbs, params.m
    return 2 * n * (2 * l) * 2 * L * m * 4


# ---------------------------------------------------------------------------
# Plain versions (int64, canonical): the twin of the whole rotation is these
# two functions composed (models/bootstrap._external_step).
# ---------------------------------------------------------------------------


def flatten_ntt_fwd_i64(ctx, a_acc, b_acc, seed2, step: int, prune: int = 0,
                        gate0: int = 0):
    """(B, L, m) accumulators -> d_hat (B, 2(l-prune), L, m), canonical.
    gate0: the global index of the first gate, which the randomized masks'
    counters take (a tile of a larger batch)."""
    rns = ctx.rns
    if seed2 is None:
        da = rns_mod.flatten(rns, a_acc, prune)
        db = rns_mod.flatten(rns, b_acc, prune)
    else:
        c0 = None
        if gate0:
            B, m = a_acc.shape[0], a_acc.shape[-1]
            gates = torch.arange(gate0, gate0 + B, dtype=torch.int64, device=a_acc.device)
            c0 = gates[:, None] * m + torch.arange(m, dtype=torch.int64, device=a_acc.device)
        da, db = rns_mod.flatten_random(rns, torch.stack([a_acc, b_acc]), ctx.fused.moduli,
                                        seed2, step, op=(0, 1), prune=prune, c0=c0)
    return ntt_mod.ntt_fwd(ctx.plan_Q, torch.cat([da, db], dim=-3))


def mac_rotate_ntt_inv_i64(ctx, d_hat, ck_hat, ck_shoup, u_k, prune: int = 0,
                           t_carry=None):
    """One step's key product, monomial and inverse NTT.

    d_hat (B, 2lk, L, m); ck_hat/ck_shoup (2l, 2, L, m); u_k (B,). t_carry:
    None (T by w-multiplies) or the two canonical hats carried from the last
    step. Returns (a, b, val_a, val_b): the new accumulators and their hats."""
    plan = ctx.plan_Q
    rns = ctx.rns
    p = plan.p
    l = plan.num_limbs
    lk = l - prune
    outs, vals = [], []
    for c in range(2):
        s_acc = None
        for row in range(2 * lk):
            krow = prune + row if row < lk else l + prune + (row - lk)
            prod = mm.shoup_mul(d_hat[..., row, :, :], ck_hat[krow, c], ck_shoup[krow, c], p)
            s_acc = prod if s_acc is None else mm.addmod(s_acc, prod, p)
        if t_carry is not None:
            t_acc = t_carry[c]
        else:
            t_acc = None
            for i in range(lk):
                row = i if c == 0 else lk + i
                wprod = mm.shoup_mul(
                    d_hat[..., row, :, :], rns.w_val[prune + i], rns.w_shoup[prune + i], p
                )
                t_acc = wprod if t_acc is None else mm.addmod(t_acc, wprod, p)
        rot = ntt_mod.monomial_mul_hat(plan, s_acc, u_k)
        val = mm.addmod(mm.submod(rot, s_acc, p), t_acc, p)
        vals.append(val)
        outs.append(ntt_mod.ntt_inv(plan, val))
    return outs[0], outs[1], vals[0], vals[1]


def flatten_ntt_fwd_plain(ctx, acc, step: int, seed2=None, prune: int = 0):
    """Plain version of the flatten_ntt_fwd kernel, on its layouts."""
    d_hat = flatten_ntt_fwd_i64(ctx, mm.u32(acc[0]), mm.u32(acc[1]), seed2, step, prune)
    return d_hat.to(torch.int32)


def mac_rotate_ntt_inv_plain(ctx, d_hat, key_hat, step: int, u, prune: int = 0):
    """Plain version of the mac_rotate_ntt_inv kernel, on its layouts."""
    ck = mm.u32(key_hat[step])
    # the MAC's Shoup products are exact remainders (mm.shoup_mul): the
    # key's companions are not needed
    a, b, _, _ = mac_rotate_ntt_inv_i64(ctx, mm.u32(d_hat), ck, ck, mm.u32(u), prune)
    return torch.stack([a, b]).to(torch.int32)


def blind_rotate_fused_plain(ctx, bkey_hat, ua, a0, b0, seed2=None, prune: int = 0,
                             gates: int | None = None):
    """Plain version of the rotate_resident kernel: the whole n-step rotation
    as `_rotate_kernel` computes it, in int64. When prune == 0 the T-term is
    carried: the canonical hat of a0 and b0, then each step's val; else it
    is computed by w-multiplies. Runs tiles of `gates` gates (all at once by
    default), each with its global gate index in the mask counters, as the
    kernel's blocks do. ua (B, n) exponents mod 2m; a0, b0 (B, L, m) int64
    canonical; bkey_hat (n, 2l, 2, L, m) int32. Returns (a, b), int64."""
    plan = ctx.plan_Q
    B, n = a0.shape[0], bkey_hat.shape[0]
    G = gates or B
    outs = []
    for g0 in range(0, B, G):
        a, b = mm.u32(a0[g0:g0 + G]), mm.u32(b0[g0:g0 + G])
        t = None if prune else (ntt_mod.ntt_fwd(plan, a), ntt_mod.ntt_fwd(plan, b))
        for k in range(n):
            ck = mm.u32(bkey_hat[k])
            d_hat = flatten_ntt_fwd_i64(ctx, a, b, seed2, k, prune, gate0=g0)
            # the MAC's Shoup products are exact remainders (mm.shoup_mul):
            # the key's companions are not needed
            a, b, va, vb = mac_rotate_ntt_inv_i64(ctx, d_hat, ck, ck, ua[g0:g0 + G, k],
                                                  prune, t)
            t = None if prune else (va, vb)
        outs.append((a, b))
    return torch.cat([o[0] for o in outs]), torch.cat([o[1] for o in outs])


# ---------------------------------------------------------------------------
# Launch plans: each kernel's block shape, chosen from (B, L, m, prune) and
# the card's SM count. csrc/rotate.cu reads a plan as FwdPlan / MacPlan.
# ---------------------------------------------------------------------------

SMEM_BLOCK = 232_448     # shared memory one block may use (H100)
SMEM_SM = 233_472        # shared memory of one SM
SMEM_RESERVED = 1_024    # the runtime's share of each resident block
THREADS_SM = 2_048
BLOCKS_SM = 32
REGS_SM = 65_536
REGS_THREAD = 64         # the kernels compile to at most this
H100_SMS = 132
FWD_MAX_THREADS = 1024   # rotate.cu FWD_THREADS_MAX
MAC_THREADS = 256        # rotate.cu MAC_THREADS
RES_MAX_THREADS = 1024   # rotate_resident.cu RES_THREADS_MAX
#: A MAC block stages 2(l - prune) key rows and as many d_hat rows per
#: gate: the key costs about one gate's staging. Each chunk adds a wait
#: and two barriers, about half a gate's work.
KEY_STAGE_GATES = 1
CHUNK_COST = 0.5
MAX_M = 32_768           # one padded length-m polynomial must fit a block


def smem_pitch(m: int, odd: bool = False) -> int:
    """Words between polynomials in shared memory: one pad word per 32, and
    one more in the forward kernel (csrc/rotate.cu pad)."""
    return m + m // 32 + int(odd)


def blocks_per_sm(smem: int, threads: int) -> int:
    return min(SMEM_SM // (smem + SMEM_RESERVED), THREADS_SM // threads,
               REGS_SM // (REGS_THREAD * threads), BLOCKS_SM)


def fwd_smem(limbs: int, digits: int, m: int) -> int:
    """Bytes of shared memory of a flatten_ntt_fwd block: its padded
    polynomials."""
    return 4 * limbs * digits * smem_pitch(m, odd=True)


def mac_smem(gates: int, lk: int, m: int, chunk: int) -> int:
    """Bytes of shared memory of a mac_rotate_ntt_inv block: its gates'
    padded vals, then the ring of key and d_hat chunks (two buffers, one if
    one chunk is the whole row)."""
    ring = (1 if chunk == m else 2) * 2 * lk * (gates + 1) * chunk
    return 4 * (gates * smem_pitch(m) + ring)


def _check_envelope(m: int, ring: str = "") -> None:
    if m > MAX_M:
        raise ValueError(
            f"ring degree m = {m}{ring} exceeds the rotation kernels' envelope "
            f"m <= {MAX_M}: each block holds a whole length-m NTT in at most "
            f"{SMEM_BLOCK:,} bytes of shared memory"
        )


def check_envelope(params) -> None:
    """Raise ValueError when params' ring is beyond the kernels, naming the
    scheme's own ring degree: m = 8n in scheme 1, m = 2^(k+5)·sqrt(n) in
    scheme 2."""
    if hasattr(params, "k"):
        ring = f" (scheme 2 at k = {params.k}, n = {params.n}: m = 2^(k+5)·sqrt(n))"
    else:
        ring = f" (scheme 1 at n = {params.n}: m = 8n)"
    _check_envelope(params.m, ring)


@dataclasses.dataclass(frozen=True)
class FwdPlan:
    """flatten_ntt_fwd: one block per (gate, operand, limb group, digit
    group). All L limbs and all kept digits in one block where their
    polynomials fit shared memory, else one limb, else one digit too."""

    limbs: int
    digits: int
    threads: int
    smem: int    # bytes of dynamic shared memory
    grid: int
    per_sm: int  # resident blocks per SM

    def words(self) -> np.ndarray:
        return np.array([self.limbs, self.digits, self.threads, self.smem, self.grid],
                        dtype=np.int32)


@dataclasses.dataclass(frozen=True)
class MacPlan:
    """mac_rotate_ntt_inv: one block per (column, limb, tile of `gates`
    gates); the key rows and the gates' d_hat rows stream through a
    double-buffered shared-memory ring, `chunk` coefficients at a time."""

    gates: int
    chunk: int
    threads: int
    smem: int
    grid: int
    per_sm: int
    waves: int
    last_wave_fill: float  # share of the last wave's block slots in use

    def words(self) -> np.ndarray:
        return np.array([self.gates, self.chunk, self.threads, self.smem, self.grid],
                        dtype=np.int32)


def _fwd_threads(smem: int) -> int:
    """The smallest block that lets an SM hold the most threads: blocks
    that finish at different times overlap one another's barriers."""
    sizes = range(32, FWD_MAX_THREADS + 1, 32)
    return max(sizes, key=lambda t: (blocks_per_sm(smem, t) * t, -t))


@functools.lru_cache(maxsize=None)
def fwd_plan(B: int, L: int, m: int, prune: int, sms: int = H100_SMS) -> FwdPlan:
    """The largest block that fits: all L limbs and all kept digits, else one
    limb, else one digit."""
    _check_envelope(m)
    lk = L - prune
    for kl, kd in ((L, lk), (1, lk), (1, 1)):
        smem = fwd_smem(kl, kd, m)
        if smem > SMEM_BLOCK:
            continue
        threads = _fwd_threads(smem)
        grid = B * 2 * (L // kl) * (lk // kd)
        return FwdPlan(kl, kd, threads, smem, grid, blocks_per_sm(smem, threads))
    raise ValueError(f"no flatten_ntt_fwd block fits m = {m}")


@functools.lru_cache(maxsize=None)
def mac_plan(B: int, L: int, m: int, prune: int, sms: int = H100_SMS) -> MacPlan:
    """Pick G and the chunk. Each thread computes one quad of one gate per
    chunk, so a chunk holds G x chunk / 4 quads: from half the block's
    threads to all of them where shared memory allows. Three or more
    blocks per SM come first, then two: fewer leave too few warps to hide
    the latency of the chunks. Then the least modelled time: the block
    slots the grid occupies (waves x blocks per SM) times a block's work,
    G + KEY_STAGE_GATES + CHUNK_COST x chunks. Ties go to larger G, more
    blocks per SM and larger chunks. The constants fit a sweep of every
    plan at Params(64) and Params(512) on an H100 (ablate_rotate.py)."""
    _check_envelope(m)
    lk = L - prune
    chunks = sorted({c for c in (m, 1024, 512, 256, 128, 64, 32) if c <= m}, reverse=True)
    for least in (MAC_THREADS // 2, 1):
        best = None
        for g in range(1, min(B, 64) + 1):
            grid = 2 * L * -(-B // g)
            for c in chunks:
                if not least <= g * c // 4 <= MAC_THREADS:
                    continue
                smem = mac_smem(g, lk, m, c)
                if smem > SMEM_BLOCK:
                    continue
                per_sm = blocks_per_sm(smem, MAC_THREADS)
                slots = sms * per_sm
                waves = -(-grid // slots)
                cost = waves * per_sm * (g + KEY_STAGE_GATES + CHUNK_COST * (m // c))
                key = (per_sm < 3, per_sm < 2, cost, -g, -per_sm, -c)
                if best is None or key < best[0]:
                    fill = (grid - (waves - 1) * slots) / slots
                    best = (key, MacPlan(g, c, MAC_THREADS, smem, grid, per_sm, waves, fill))
        if best is not None:
            return best[1]
    raise ValueError(f"no mac_rotate_ntt_inv block fits m = {m}")


def resident_gate_bytes(L: int, m: int, prune: int) -> int:
    """Shared memory one gate takes in a rotate_resident block: its 2(l -
    prune) kept digit polynomials (the first of each operand doubles as its
    accumulator and val) and, when prune == 0, its carried T (2L more)."""
    lk = L - prune
    return 4 * smem_pitch(m, odd=True) * 2 * L * (lk + int(prune == 0))


@dataclasses.dataclass(frozen=True)
class ResidentPlan:
    """rotate_resident: one block per tile of `gates` gates, looping over all
    n steps; `threads` a block, as many blocks per SM as shared memory
    holds and 64 registers a thread allow."""

    gates: int
    threads: int
    smem: int
    grid: int
    per_sm: int
    waves: int

    def words(self) -> np.ndarray:
        return np.array([self.gates, self.threads, self.smem, self.grid], dtype=np.int32)


#: A block alone on its SM waits at its own barriers (eight a step at
#: m = 512) with no other block to fill them: the plan counts it as this
#: many gates' work more than its own.
LONE_BLOCK_GATES = 2


def _resident_shape(G: int, B: int, L: int, m: int, prune: int, sms: int) -> ResidentPlan:
    """The plan of G gates a block. The blocks that land on one SM at once
    (as many as shared memory holds, fewer where the grid cannot fill
    them) share its 1,024 threads of 64 registers."""
    smem = G * resident_gate_bytes(L, m, prune)
    grid = -(-B // G)
    fit = min(SMEM_SM // (smem + SMEM_RESERVED), BLOCKS_SM)
    busy = min(fit, -(-grid // sms))
    threads = max(32, min(RES_MAX_THREADS, REGS_SM // REGS_THREAD // busy) // 32 * 32)
    per_sm = blocks_per_sm(smem, threads)
    return ResidentPlan(G, threads, smem, grid, per_sm, -(-grid // (sms * per_sm)))


@functools.lru_cache(maxsize=None)
def resident_plan(B: int, L: int, l: int, m: int, prune: int, sms: int = H100_SMS,
                  gates: int | None = None) -> ResidentPlan:
    """Pick G, the gates of a rotate_resident block. The modelled time is the
    waves times the gates an SM works on at once in a full wave (blocks per
    SM, or fewer where the grid cannot fill them, times G), but at least G
    + LONE_BLOCK_GATES: a lone block's latency. Ties go to larger G (fewer
    reads of the key from L2). At B = 32 one gate a block keeps 32 SMs busy;
    at Params(64) and B = 4096 two gates a block, two blocks an SM. `gates`
    forces G. Raises ValueError when one gate's state does not fit a block's
    shared memory."""
    if l != L:
        raise ValueError(f"rotate_resident takes l = L digits, got l = {l}, L = {L}")
    if not 0 <= prune < L:
        raise ValueError(f"prune = {prune} must be in [0, L = {L})")
    per_gate = resident_gate_bytes(L, m, prune)
    if per_gate > SMEM_BLOCK:
        raise ValueError(
            f"rotate_resident: one gate's state at L = {L}, m = {m}, prune = {prune} "
            f"takes {per_gate:,} bytes of shared memory, beyond a block's limit of "
            f"{SMEM_BLOCK:,} bytes"
        )
    top = min(B, SMEM_BLOCK // per_gate)
    if gates is not None:
        if not 1 <= gates <= top:
            raise ValueError(f"rotate_resident: {gates} gates a block do not fit "
                             f"({top} at most at B = {B} within {SMEM_BLOCK:,} bytes)")
        return _resident_shape(gates, B, L, m, prune, sms)
    best = None
    for G in range(1, top + 1):
        pl = _resident_shape(G, B, L, m, prune, sms)
        busy = min(pl.per_sm, -(-pl.grid // sms))
        cost = pl.waves * max(busy * G, G + LONE_BLOCK_GATES)
        if best is None or (cost, -G) < best[0]:
            best = ((cost, -G), pl)
    return best[1]


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------


def _check(name: str, t: torch.Tensor, shape: tuple, device) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != torch.int32:
        raise TypeError(f"{name} must be int32 (uint32 bit patterns), got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _require_cuda(t: torch.Tensor) -> None:
    if t.device.type != "cuda":
        raise ValueError(
            f"the rotation kernels take CUDA tensors (CPU tensors take the "
            f"plain version), got {t.device}"
        )


def _common(ctx, t: torch.Tensor):
    ft = ctx.fused
    L, m = len(ft.moduli), ft.m
    _chk(KERNEL_LAZY_BOUND, max(ft.moduli))
    _check("tables", ft.tables, (L, 10, m), t.device)
    return ft, L, m


def flatten_ntt_fwd(ctx, acc, step: int, seed2=None, prune: int = 0):
    """acc (2, B, L, m) -> d_hat (B, 2(L-prune), L, m); see module doc."""
    if acc.device.type == "cpu":
        return flatten_ntt_fwd_plain(ctx, acc, step, seed2, prune)
    _require_cuda(acc)
    ft, L, m = _common(ctx, acc)
    B = acc.shape[1]
    assert 0 <= prune < L
    _check("acc", acc, (2, B, L, m), acc.device)
    from .. import _build

    plan = fwd_plan(B, L, m, prune, _sm_count(acc.device.index or 0)).words()
    lib = _build.load()
    d_hat = torch.empty((B, 2 * (L - prune), L, m), dtype=torch.int32, device=acc.device)
    lo, hi = (0, 0) if seed2 is None else (int(seed2[0]) & mm.MASK32, int(seed2[1]) & mm.MASK32)
    rc = lib.sg_flatten_ntt_fwd(
        acc.data_ptr(), d_hat.data_ptr(), ft.tables.data_ptr(),
        ft.consts.ctypes.data_as(ctypes.c_void_p),
        B, L, m, prune, int(ft.close), int(seed2 is not None), lo, hi,
        int(step) & mm.MASK32, torch.cuda.current_stream().cuda_stream,
        plan.ctypes.data_as(ctypes.c_void_p),
    )
    if rc != 0:
        raise RuntimeError(f"flatten_ntt_fwd launch failed: cudaError {rc}")
    flatten_ntt_fwd.launches += 1
    return d_hat


flatten_ntt_fwd.launches = 0


def mac_rotate_ntt_inv(ctx, d_hat, key_hat, step: int, u, prune: int = 0):
    """d_hat (B, 2(L-prune), L, m), key_hat (n, 2L, 2, L, m), u (B,)
    exponents of this step -> new acc (2, B, L, m); see module doc."""
    if d_hat.device.type == "cpu":
        return mac_rotate_ntt_inv_plain(ctx, d_hat, key_hat, step, u, prune)
    _require_cuda(d_hat)
    ft, L, m = _common(ctx, d_hat)
    B = d_hat.shape[0]
    n = key_hat.shape[0]
    assert 0 <= prune < L and 0 <= step < n
    dev = d_hat.device
    _check("d_hat", d_hat, (B, 2 * (L - prune), L, m), dev)
    _check("key_hat", key_hat, (n, 2 * L, 2, L, m), dev)
    _check("u", u, (B,), dev)
    from .. import _build

    plan = mac_plan(B, L, m, prune, _sm_count(dev.index or 0)).words()
    lib = _build.load()
    acc = torch.empty((2, B, L, m), dtype=torch.int32, device=dev)
    step_bytes = key_hat[0].numel() * 4
    rc = lib.sg_mac_rotate_ntt_inv(
        d_hat.data_ptr(), key_hat.data_ptr() + step * step_bytes, u.data_ptr(),
        acc.data_ptr(), ft.tables.data_ptr(), ft.consts.ctypes.data_as(ctypes.c_void_p),
        B, L, m, prune, torch.cuda.current_stream().cuda_stream,
        plan.ctypes.data_as(ctypes.c_void_p),
    )
    if rc != 0:
        raise RuntimeError(f"mac_rotate_ntt_inv launch failed: cudaError {rc}")
    mac_rotate_ntt_inv.launches += 1
    return acc


mac_rotate_ntt_inv.launches = 0


def blind_rotate_steps(ctx, bkey_hat, ua, a0, b0, seed2=None, prune: int = 0):
    """The n-step rotation through the two step wrappers: 2n launches on
    CUDA tensors (the streamed route). ua (B, n) exponents mod 2m; a0, b0
    (B, L, m) int64 canonical; bkey_hat (n, 2l, 2, L, m) int32, the hat
    alone. Returns the accumulators as int64 (B, L, m)."""
    n = bkey_hat.shape[0]
    acc = torch.stack([a0, b0]).to(torch.int32).contiguous()
    u_steps = ua.t().contiguous().to(torch.int32)
    for k in range(n):
        d_hat = flatten_ntt_fwd(ctx, acc, k, seed2, prune)
        acc = mac_rotate_ntt_inv(ctx, d_hat, bkey_hat, k, u_steps[k], prune)
    return acc[0].to(torch.int64), acc[1].to(torch.int64)


def blind_rotate_fused(ctx, bkey_hat, ua, a0, b0, seed2=None, prune: int = 0,
                       gates: int | None = None):
    """The whole n-step rotation in one rotate_resident launch on CUDA
    tensors (counterpart of sgfhe_tpu/ops/fused.blind_rotate_fused); CPU
    tensors take `blind_rotate_fused_plain` on the same tiles. ua (B, n)
    exponents mod 2m; a0, b0 (B, L, m) int64 canonical; bkey_hat (n, 2l, 2,
    L, m) int32, the hat alone (the kernel needs no Shoup companions).
    gates forces the plan's G; a shape whose state does not fit a block
    raises ValueError on every device. Returns (a, b) as int64 (B, L, m)."""
    B, L, m = a0.shape
    n = bkey_hat.shape[0]
    dev = a0.device
    sms = _sm_count(dev.index or 0) if dev.type == "cuda" else H100_SMS
    plan = resident_plan(B, L, L, m, prune, sms, gates)
    if dev.type == "cpu":
        return blind_rotate_fused_plain(ctx, bkey_hat, ua, a0, b0, seed2, prune, plan.gates)
    _require_cuda(a0)
    ft, _, _ = _common(ctx, a0)
    _check("bkey_hat", bkey_hat, (n, 2 * L, 2, L, m), dev)
    acc = torch.stack([a0, b0]).to(torch.int32).contiguous()
    u = ua.to(torch.int32).contiguous()
    _check("ua", u, (B, n), dev)
    from .. import _build

    lib = _build.load("rotate_resident.cu")
    out = torch.empty_like(acc)
    lo, hi = (0, 0) if seed2 is None else (int(seed2[0]) & mm.MASK32, int(seed2[1]) & mm.MASK32)
    words = plan.words()
    rc = lib.sg_rotate_resident(
        acc.data_ptr(), out.data_ptr(), bkey_hat.data_ptr(), u.data_ptr(),
        ft.tables.data_ptr(), ft.consts.ctypes.data_as(ctypes.c_void_p),
        B, L, n, m, prune, int(ft.close), int(seed2 is not None), lo, hi,
        torch.cuda.current_stream().cuda_stream, words.ctypes.data_as(ctypes.c_void_p),
    )
    if rc != 0:
        raise RuntimeError(f"rotate_resident launch failed: cudaError {rc}")
    blind_rotate_fused.launches += 1
    return out[0].to(torch.int64), out[1].to(torch.int64)


blind_rotate_fused.launches = 0
