"""The blind rotation's step kernels (csrc/rotate.cu), their wrappers and
their plain PyTorch versions.

Counterpart of sgfhe_tpu/ops/fused.py, whose two Pallas TPU kernels,
`_rotate_kernel` (key resident, T-term carried) and `_rotate_step_kernel`
(key streamed, T-term by w-multiplies), run all n steps of a batch tile in
one launch. Here one step is two CUDA launches, and the n-step loop
(`blind_rotate_steps`) runs on the host:

  flatten_ntt_fwd      acc (2, B, L, m) -> d_hat (B, 2(l-prune), L, m):
                       balanced mixed-radix digits of both accumulators
                       (Threefry-masked in randomized mode), forward NTT.
  mac_rotate_ntt_inv   d_hat + key slice of step k -> new acc (2, B, L, m):
                       Shoup MAC against the key, T-term, x^{u_k}, inverse
                       NTT. t_mode 0 computes T by w-multiplies (the
                       streamed TPU kernel); t_mode 1 also writes val to
                       `carry` and t_mode 2 reads T from it (the resident
                       TPU kernel's hat-carry, valid only when prune == 0).

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


def flatten_ntt_fwd_i64(ctx, a_acc, b_acc, seed2, step: int, prune: int = 0):
    """(B, L, m) accumulators -> d_hat (B, 2(l-prune), L, m), canonical."""
    rns = ctx.rns
    if seed2 is None:
        da = rns_mod.flatten(rns, a_acc, prune)
        db = rns_mod.flatten(rns, b_acc, prune)
    else:
        da, db = rns_mod.flatten_random(rns, torch.stack([a_acc, b_acc]), ctx.fused.moduli,
                                        seed2, step, op=(0, 1), prune=prune)
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


def mac_rotate_ntt_inv_plain(ctx, d_hat, key_hat, key_shoup, step: int, u,
                             prune: int = 0, t_mode: int = 0, carry=None):
    """Plain version of the mac_rotate_ntt_inv kernel, on its layouts."""
    t = (mm.u32(carry[0]), mm.u32(carry[1])) if t_mode == 2 else None
    a, b, va, vb = mac_rotate_ntt_inv_i64(
        ctx, mm.u32(d_hat), mm.u32(key_hat[step]), mm.u32(key_shoup[step]),
        mm.u32(u), prune, t,
    )
    if t_mode:
        carry.copy_(torch.stack([va, vb]).to(torch.int32))
    return torch.stack([a, b]).to(torch.int32)


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
REGS_THREAD = 64         # rotate.cu compiles both kernels to at most this
H100_SMS = 132
FWD_MAX_THREADS = 1024   # rotate.cu FWD_THREADS_MAX
MAC_THREADS = 256        # rotate.cu MAC_THREADS
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


def mac_rotate_ntt_inv(ctx, d_hat, key_hat, key_shoup, step: int, u,
                       prune: int = 0, t_mode: int = 0, carry=None):
    """d_hat (B, 2(L-prune), L, m), key (n, 2L, 2, L, m), u (B,) exponents of
    this step -> new acc (2, B, L, m); carry (2, B, L, m) is written for
    t_mode 1 and read and written for t_mode 2 (see module doc)."""
    assert t_mode in (0, 1, 2)
    assert t_mode == 0 or (prune == 0 and carry is not None), (
        "hat-carry T-term represents the UNpruned accumulator"
    )
    if d_hat.device.type == "cpu":
        return mac_rotate_ntt_inv_plain(
            ctx, d_hat, key_hat, key_shoup, step, u, prune, t_mode, carry
        )
    _require_cuda(d_hat)
    ft, L, m = _common(ctx, d_hat)
    B = d_hat.shape[0]
    n = key_hat.shape[0]
    assert 0 <= prune < L and 0 <= step < n
    dev = d_hat.device
    _check("d_hat", d_hat, (B, 2 * (L - prune), L, m), dev)
    _check("key_hat", key_hat, (n, 2 * L, 2, L, m), dev)
    _check("key_shoup", key_shoup, (n, 2 * L, 2, L, m), dev)
    _check("u", u, (B,), dev)
    if t_mode:
        _check("carry", carry, (2, B, L, m), dev)
    from .. import _build

    plan = mac_plan(B, L, m, prune, _sm_count(dev.index or 0)).words()
    lib = _build.load()
    acc = torch.empty((2, B, L, m), dtype=torch.int32, device=dev)
    step_bytes = key_hat[0].numel() * 4
    rc = lib.sg_mac_rotate_ntt_inv(
        d_hat.data_ptr(), key_hat.data_ptr() + step * step_bytes,
        key_shoup.data_ptr() + step * step_bytes, u.data_ptr(), acc.data_ptr(),
        carry.data_ptr() if t_mode else None, ft.tables.data_ptr(),
        ft.consts.ctypes.data_as(ctypes.c_void_p),
        B, L, m, prune, t_mode, torch.cuda.current_stream().cuda_stream,
        plan.ctypes.data_as(ctypes.c_void_p),
    )
    if rc != 0:
        raise RuntimeError(f"mac_rotate_ntt_inv launch failed: cudaError {rc}")
    mac_rotate_ntt_inv.launches += 1
    return acc


mac_rotate_ntt_inv.launches = 0


def blind_rotate_steps(ctx, bkey_hat, bkey_shoup, ua, a0, b0, seed2=None,
                       prune: int = 0, carry: bool = False):
    """The n-step rotation through the two step wrappers: 2n launches on
    CUDA tensors. ua (B, n) exponents mod 2m; a0, b0 (B, L, m) int64
    canonical. carry=True takes the T-term from the last step's val (t_mode
    2; step 0 computes it by w-multiplies and writes it). Returns the
    accumulators as int64 (B, L, m)."""
    assert not (carry and prune), "hat-carry needs prune == 0"
    n = bkey_hat.shape[0]
    acc = torch.stack([a0, b0]).to(torch.int32).contiguous()
    u_steps = ua.t().contiguous().to(torch.int32)
    carry_buf = torch.empty_like(acc) if carry else None
    for k in range(n):
        d_hat = flatten_ntt_fwd(ctx, acc, k, seed2, prune)
        t_mode = 0 if not carry else (1 if k == 0 else 2)
        acc = mac_rotate_ntt_inv(
            ctx, d_hat, bkey_hat, bkey_shoup, k, u_steps[k], prune, t_mode, carry_buf
        )
    return acc[0].to(torch.int64), acc[1].to(torch.int64)
