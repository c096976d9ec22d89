"""Drive sgfhe_tpu_torch's main path on one NVIDIA card and hold its CUDA
kernels against their plain PyTorch versions.

    python3 chip_smoke.py

Phases, each printing its own lines; any failure raises and exits nonzero:
  1. the card's name and power limit; build the kernels from csrc/ (one
     nvcc a source, started together).
  2. the kernels vs the twin on the card, bit for bit, at Params(64) with
     port-made keys: exact, prune 1 and 2, randomized, and near-2^29 moduli
     with l = 3; the step pair, and rotate_resident (the whole rotation in
     one launch) == its plain version == the twin == the step pair, one
     launch each.
  2b. one step of each step-pair kernel against its plain version, bit for
     bit, at L in {2, 3, 4} x m in {512, 1024, 2048, 4096, 8192, 16384,
     32768} with near-2^29 moduli, random canonical inputs and key slice,
     B = 1 and a batch whose last gate tile is partial, every prune, exact
     and randomized; rotate_resident == plain == the step pair
     at every (L, m) whose key the route admits, n = 64 steps, B = 1 and a
     batch whose last gate tile is partial, every prune, both modes.
  3. each kernel against its plain version at the main paths' shapes
     (Params(64), Params(512), scheme 2 at k=1), the forward kernel exact
     and randomized, with its time (steps 0..n-1 in turn, as the main path walks the key),
     the plain version's time and its bound; rotate_resident at Params(64)
     and B = 4096 in four modes (exact, randomized, prune 1 and 2): ms a
     launch (a whole rotation), the plain version's ms, the bound over the
     whole loop; its ms at every gate tile that fits, the step pair's whole
     rotation on the same gates, its registers and spills; then one step of
     each step-pair kernel, bit for bit against plain, exact and randomized, at
     every other batch a main path launches (mul's 1024, 512 and 256 lanes;
     the pack's 512 at Params(512)).
  3s. the exact Q->r switch's kernel (csrc/rescale.cu) against its plain
     version on the card, bit for bit, at a gate batch's a and b of
     Params(512) (B = 256), Params(64) (B = 131072) and scheme 2 at k = 4
     (512 lanes): ms a launch, the plain version's ms, the bound; its
     registers and spills.
  4. main path at Params(64): keygen, encrypt, split, bootstrap_batch on
     4096 gates, decrypt_bit, AND/OR/XOR truth tables, in exact, randomized,
     prune 1 and prune 2 modes through rotate_resident (one launch a
     rotation), alternating with the same gates through the step pair (2n
     launches), outputs equal bit for bit; gates/s of both routes, and a
     profiler trace of one exact call of each (device busy and idle time,
     each kernel's own device time, the kernels the host launched; every
     phase's traces print these).
  5. main path at Params(512), full width (576 MiB key): 256 gates, truth
     tables, gates/s, launches == 2n per call, the trace, the twin's time on
     the card for the same batch and its equality with the kernels' output.
  6. scheme 2 at the paper's k=1, n=1024, full width and depth (r = 4096,
     m = 2048, L = 3, RNS q; 576 MiB key made on the card): add_with_carry
     on 1024 digit pairs (2048 lanes) and mul on 256 pairs, every output
     digit decrypted against plaintext arithmetic, adds/s and muls/s,
     launches == 2n per rotation round, a trace of one add_with_carry
     call; and at the toy n = 64 (k=1, a smaller depth; phase 12 does the
     same at n = 1024), on 4 pairs the kernels' output of add_with_carry
     and of mul equal to the twin's in deterministic and randomized mode,
     one rotate_resident launch a rotation.
  7. the rest of scheme 1's API at Params(512): a public key, its
     ciphertexts through split, bootstrap_batch and decrypt (truth
     tables), the space-optimal round trip for both key types, and
     pack_encrypted_bits of 512 bootstrapped bits decrypted from its
     length-m ciphertext, with its time, and its kernels' output equal to
     the twin's in deterministic and randomized mode.
  8. the boolean-circuit layer at Params(512): ripple_adder(16) and
     comparator(16) on 64 instances through circuit.evaluate, every output
     bit against evaluate_plain (deterministic and randomized), launches
     == 2n a level, seconds an evaluation and additions/s, the noise report
     of the adder's outputs; one step of each kernel == plain at every
     level batch; ripple_adder(8) at Params(64) through rotate_resident
     (one launch a level) equal to plain, deterministic and with each
     level's seed words given.
  9. wide integers at scheme 2's k=1, n=1024 (the phase-6 key), W = 3
     digits, 64 numbers: add_wide, sub_wide, mul_wide and min_max_wide
     timed, select_wide, eq_wide and sort_wide (N = 4), randomized
     sub_wide and min_max_wide, every value against numpy; one step of each
     kernel == plain at every batch these ops launch; min_max_wide and
     mul_wide at the toy n=64 (a smaller depth), W = 2, B = 2, through
     rotate_resident (one launch a rotation) equal to plain with pinned
     seed words.
  10. scheme 2 at k=2 and k=4, n=1024 (m = 4096 and 16384, L = 3 and 4):
     each key made on the card after a free-memory check, add_with_carry
     on 1024 and 256 pairs (adds/s, every digit, max |phase noise|, a
     trace), add_wide of 64 two-digit numbers, each kernel timed against
     plain and its bound at the shape, and the -Xptxas -v line of the
     L = 4 randomized forward kernel.
  11. Params(1024) served through the wire (n = 1024, m = 8192, L = l = 3,
     2304 MiB key made on the card after a free-memory check): the private
     key and the seeded bootstrap-key frame written (sizes, seconds and
     MB/s of to_wire and from_wire), the key loaded on the card equal bit
     for bit; two 1024-bit messages sent as PackedCiphertext frames, split
     and bootstrapped on the loaded key (1024 gates, gates/s, launches ==
     2n per call, a trace), the three output batches sent back as
     EncryptedBit frames and all 3072 outputs decrypted against the truth
     tables, deterministic and randomized; each kernel timed against plain
     and its bound at (1024, 3, 8192) and one step == plain there; the
     phase-6 scheme-2 key (k = 1, n = 1024, eight 128-index chunks of
     stream 2) through its seeded frame equal bit for bit; every other
     frame type and an npz checkpoint round-tripped once at Params(64).
  12. scheme 2 at k=3, n=1024 (m = 8192, L = l = 3, 2304 MiB key made on
     the card after a free-memory check): add_with_carry on 512 pairs
     (1024 lanes, Params(1024)'s kernel shape) exact, randomized and with
     prune = 2, mul on 128 pairs, every digit and carry decrypted against
     plaintext arithmetic, adds/s, muls/s, max |phase noise|, launches ==
     2n per rotation round, a trace of one add; one step == plain at every
     batch these launch; on 4 pairs the kernels' add_with_carry and mul
     equal to the twin's, deterministic and randomized.
  13. scheme 2 at k=5, n=1024 (m = 32768 = the kernels' MAX_M, L = l = 4,
     16 GiB key made on the card after a free-memory check, its build
     timed): add_with_carry on 256 pairs (512 lanes) exact, one traced
     call then adds/s over two more, max |phase noise|; randomized and
     prune = 1 on 32 pairs,
     every digit and carry right; each kernel timed against plain and its
     bound at (512, 4, 32768), the forward kernel exact and randomized; one
     step == plain at
     every batch the phase launches.
  14. the single-card examples in-process on the card: adder (8 bits,
     n = 64, 4 instances) and depth (10 generations, n = 64), each checking
     its own results, one rotate_resident launch a rotation.
  15. the multi-device layer (parallel/) at world size 1 over NCCL: (a)
     bootstrap_batch_sharded on the (1, 1) mesh, phase 11's 1024 gates at
     Params(1024) through the kernels, == bootstrap_batch bit for bit,
     truth tables, launches == 2n per call, gates/s beside phase 11's;
     (b) bootstrap_batch_tp at (m1, m2) = (64, 128) on 8 gates through all
     1024 steps, exact and randomized, == the kernel route bit for bit,
     seconds of bkey_to_dist and of each call, peak memory; (c) the
     scheme2_dist example at k = 4 (after a free-memory check), its
     add_with_carry_dist == the kernel route's add_with_carry at prune 0
     and 1, every digit and carry right; (d) the scaling example at 256
     gates, n = 64, one rotate_resident launch a rotation.
Each phase prints its seconds, and the build and phases their total. The
line before the last is the kernel table as JSON; the last line is
{"ok": true, "device": {...}}. Without a CUDA device, or outside a checkout
of the repository, it exits nonzero and prints no result.
"""

from __future__ import annotations

import dataclasses
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path
from unittest import mock

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
# NVIDIA's H100 SXM data sheet gives 67 TFLOP/s float32, an FMA counted as 2
# operations on 128 lanes per SM; Hopper has 64 int32 multiply-add lanes per
# SM, so int32 multiplies run at a quarter of that rate.
INT32_MUL_PER_S = 67e12 / 4
SHOUP_MULS = 3  # a*w, mulhi(a, w'), q*p
SEED2 = (0x12345678, 0x9ABCDEF0)


def fail(msg: str):
    raise RuntimeError(msg)


def smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else "nvidia-smi: no output"


def cuda_ms(fn, reps: int) -> float:
    """Mean ms of fn(0), ..., fn(reps - 1) by CUDA events, after fn(0)."""
    import torch

    fn(0)
    torch.cuda.synchronize()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(reps):
        fn(i)
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def bound(bytes_moved: float, muls: float):
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = muls / INT32_MUL_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def fwd_cost(B, L, m, lk, randomized):
    """Bytes and int32 multiplies one flatten_ntt_fwd launch needs: the
    digit chain (and in randomized mode the masks) once per coefficient,
    one forward NTT per (gate, operand, kept digit, limb)."""
    logm = m.bit_length() - 1
    nbytes = 2 * B * L * m * 4 + B * 2 * lk * L * m * 4 + L * 2 * m * 4
    coeffs = 2 * B * m
    chain = L * (L - 1) // 2 * SHOUP_MULS  # digit d takes d Shoup steps
    masks = lk * L * (1 + SHOUP_MULS) if randomized else 0  # v % p_j, times w
    ntt = B * 2 * lk * L * (m // 2) * logm * SHOUP_MULS
    return nbytes, coeffs * (chain + masks) + ntt


def mac_cost(B, L, m, lk):
    """Bytes and int32 multiplies one mac_rotate_ntt_inv launch needs."""
    logm = m.bit_length() - 1
    nbytes = (B * 2 * lk * L * m * 4 + 2 * (2 * lk * 2 * L * m * 4) + B * 4
              + 2 * B * L * m * 4 + L * 8 * m * 4)
    per_elem = 2 * lk + lk + 1 + 1  # MAC, T-term, x^u, inverse twist
    muls = 2 * B * L * (m * per_elem + (m // 2) * logm)
    return nbytes, muls * SHOUP_MULS


def resident_cost(B, L, m, n, lk, randomized, carry):
    """Bytes and int32 multiplies one rotate_resident launch needs, the whole
    n-step loop reckoned as fwd_cost and mac_cost reckon a step: the
    accumulators read once and written once, the key's kept rows read once
    (the gate tiles share them in L2), the exponents and tables; n steps of
    the forward and MAC work (the T-term carried, or by w-multiplies when
    pruned), and with a carried T the forward NTT of the entry
    accumulators."""
    logm = m.bit_length() - 1
    nbytes = (2 * 2 * B * L * m * 4 + n * 2 * lk * 2 * L * m * 4 + B * n * 4
              + L * 10 * m * 4)
    step = fwd_cost(B, L, m, lk, randomized)[1] + mac_cost(B, L, m, lk)[1]
    if carry:  # a carried T-term takes no w-multiplies
        step -= 2 * B * L * m * lk * SHOUP_MULS
    entry = B * 2 * L * (m // 2) * logm * SHOUP_MULS if carry else 0
    return nbytes, n * step + entry


def switch_rows(reps: int = 200) -> list:
    """The exact Q->r switch's kernel (csrc/rescale.cu) at the main paths'
    shapes, a (B, L, n) and b (B, L, 1) of a gate batch: == its plain
    version on the card bit for bit; ms a launch by CUDA events (the
    wrapper's host time where that is longer); the kernel's device ms in a
    profiler trace; the plain version's ms (its eager launches, as the
    main path ran them before the kernel); the bound (8 bytes a residue
    read and a result written). One kernel-table row each."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    import sgfhe_tpu_torch as T
    from sgfhe_tpu_torch.ops import rns

    dev = torch.device("cuda")
    p512, p64, p4 = T.Params.create(512), T.Params.create(64), T.Scheme2.Params.create(4)
    shapes = [("n=512, B=256", p512, 256), ("n=64, B=131072", p64, 131072),
              ("s2 k=4, 512 lanes", p4, 512)]
    rows = []
    gen = torch.Generator(device=dev).manual_seed(11)
    for tag, params, B in shapes:
        moduli, r = params.moduli, params.r
        L = len(moduli)
        ctx = rns.build_context(moduli).device_context(dev)
        p = torch.tensor(moduli, dtype=torch.int64, device=dev).reshape(L, 1)
        nl = rns.switch_consts(moduli, r, True).nl
        for part, m in (("a", params.n), ("b", 1)):
            x = torch.randint(0, 1 << 30, (B, L, m), generator=gen, device=dev) % p
            got = rns.rescale_exact(ctx, x, r, moduli)
            want = rns.rescale_exact_plain(ctx, x, r, moduli)
            torch.cuda.synchronize()
            err = int((got - want).abs().max())
            if err:
                fail(f"[3s] rescale_exact {part} ({tag}) vs plain max_abs_err {err}")
            ms = cuda_ms(lambda i: rns.rescale_exact(ctx, x, r, moduli), reps)
            pms = cuda_ms(lambda i: rns.rescale_exact_plain(ctx, x, r, moduli), 10)
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(20):
                    rns.rescale_exact(ctx, x, r, moduli)
                torch.cuda.synchronize()
            dev_ms = [e.self_device_time_total / 1e3 / e.count for e in prof.key_averages()
                      if "rescale_exact_kernel" in e.key]
            coeffs = B * m
            muls = coeffs * (L * (L - 1) // 2 * SHOUP_MULS + 2 * (L + 1) * nl)
            bms, by = bound(8 * coeffs * (L + 1), muls)
            name = f"rescale_exact {part} ({tag})"
            rows.append(dict(
                name=name, route="cuda", source="sgfhe_tpu_torch/csrc/rescale.cu",
                replaces="none (the JAX package's rescale_exact is jnp)", launches=None,
                calls=None, max_abs_err=err, ms=ms, plain_ms=pms, bound_ms=bms, bound_by=by,
                library_ms=None, trace_ms=dev_ms[0] if dev_ms else None,
            ))
            print(f"[3s] {name}: {ms:.4f} ms/launch ({ms / bms:.1f}x bound), in the trace "
                  f"{rows[-1]['trace_ms']} ms, plain {pms:.3f} ms, bound {bms:.4f} ms "
                  f"({by}), max_abs_err {err}")
    return rows


def ptxas_entry(text: str, kernel: str) -> str:
    """The `-Xptxas -v` lines of the entry functions whose mangled name
    holds `kernel`, one string."""
    out, keep = [], False
    for line in text.splitlines():
        if "Compiling entry function" in line:
            keep = kernel in line
        if keep:
            out.append(line.replace("ptxas info    :", "").strip())
    return " | ".join(out) or f"no ptxas lines for {kernel}"


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not (ROOT / "sgfhe_tpu_torch" / "csrc" / "rotate.cu").is_file():
        print("chip_smoke: run from a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import sgfhe_tpu_torch as T
    from sgfhe_tpu_torch import _build
    from sgfhe_tpu_torch import circuit as C
    from sgfhe_tpu_torch import serialize as S
    from sgfhe_tpu_torch.debug import noise as noise_dbg
    from sgfhe_tpu_torch.models import wideint as WI
    from sgfhe_tpu_torch.models.scheme1 import KEY_CHUNK_BYTES
    from sgfhe_tpu_torch.models import bootstrap as tbs
    from sgfhe_tpu_torch.ops import fused
    from sgfhe_tpu_torch.ops import modmath as mm
    from sgfhe_tpu_torch.ops import prg
    from sgfhe_tpu_torch.utils import primes

    S2, B2 = T.Scheme2, T.Scheme2Boot
    dev = torch.device("cuda")
    card = smi()
    print(f"[1] card: {card}")
    print(f"[1] python {sys.version.split()[0]} torch {torch.__version__} cuda {torch.version.cuda}")
    t0 = time.perf_counter()
    # registers, stack frames and spills of every kernel instance, from a
    # second nvcc run a source beside the build (phase 3 prints the resident
    # kernel's lines, phase 10 the L = 4 forward kernel's)
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    ptxas = [subprocess.Popen(
        [_build._nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-cubin", "-Xptxas", "-v", "-o", str(_build.BUILD_DIR / f"ptxas-{src}.cubin"),
         str(_build.CSRC / src)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True) for src in _build.SOURCES]
    try:
        _build.build_all()
        ptxas_text = "\n".join(px.communicate(timeout=600)[0] for px in ptxas)
    finally:
        for px in ptxas:
            if px.poll() is None:
                px.kill()
                px.communicate()
    print(f"[1] kernels built in {time.perf_counter() - t0:.1f} s")
    t_start = t0
    phase_t = [time.perf_counter()]

    def phase_done(tag):
        torch.cuda.synchronize()
        now = time.perf_counter()
        print(f"[{tag}] phase took {now - phase_t[0]:.1f} s")
        phase_t[0] = now

    def reset():
        fused.flatten_ntt_fwd.launches = 0
        fused.mac_rotate_ntt_inv.launches = 0
        fused.blind_rotate_fused.launches = 0

    def counts():
        """The step pair's launches (flatten_ntt_fwd, mac_rotate_ntt_inv)."""
        return fused.flatten_ntt_fwd.launches, fused.mac_rotate_ntt_inv.launches

    def rcount():
        """rotate_resident's launches."""
        return fused.blind_rotate_fused.launches

    def resident_route(params):
        return tbs._rotation_route(params, dev) == "resident"

    def twin():
        """While open, every rotation takes the twin, on the card too."""
        return mock.patch.object(tbs, "_rotation_route", lambda params, device: "plain")

    def expect_launches(tag, params, rotations):
        """Since the last reset(): one rotate_resident launch a rotation for
        a resident-size key and no step-pair launch, else 2n a rotation and
        no resident launch. Returns a description."""
        got = (counts(), rcount())
        if resident_route(params):
            want = ((0, 0), rotations)
        else:
            want = ((rotations * params.n,) * 2, 0)
        if got != want:
            fail(f"[{tag}] launches (step pair, rotate_resident) {got}, expected {want} for "
                 f"{rotations} rotations at n = {params.n}")
        if resident_route(params):
            return f"rotate_resident {rotations} = 1 a rotation, step pair 0"
        return f"(flatten_ntt_fwd, mac_rotate_ntt_inv) {got[0]} = 2n a rotation, rotate_resident 0"

    class CountRotations:
        """Counts the calls of models/bootstrap.blind_rotate (every gate and
        digit rotation of both schemes, the sharded path's too) while open."""

        def __enter__(self):
            self.n, self.orig = 0, tbs.blind_rotate

            def counted(*a, **k):
                self.n += 1
                return self.orig(*a, **k)

            tbs.blind_rotate = B2.blind_rotate = counted
            return self

        def __exit__(self, *exc):
            tbs.blind_rotate = B2.blind_rotate = self.orig

    def keys(params, seed, ctx=None):
        ctx = ctx or T.make_context(params, device=dev)
        g = torch.Generator().manual_seed(seed)
        sk = T.PrivateKey.create(params, g, device=dev)
        return ctx, sk, T.BootstrapKey.create(ctx, sk, g), g

    def rand_acc(params, B, seed):
        gen = torch.Generator().manual_seed(seed)
        L, m = params.num_limbs, params.m
        p = torch.tensor(params.moduli).reshape(L, 1)
        ua = torch.randint(0, 2 * m, (B, params.n), generator=gen)
        a0 = torch.randint(0, 1 << 30, (B, L, m), generator=gen) % p
        b0 = torch.randint(0, 1 << 30, (B, L, m), generator=gen) % p
        return ua.to(dev), a0.to(dev), b0.to(dev)

    # ---- 2. kernels vs twin, every mode --------------------------------------
    p64 = T.Params.create(64)
    ctx64, sk64, bk64, g64 = keys(p64, 1)
    mods = primes.find_rns_primes(2 * p64.m, 1 << 86, (1 << 87) - 1, 3)
    if not 12 * max(mods) > (1 << 32):
        fail("synthetic moduli do not reach the reset regime")
    p_big = dataclasses.replace(p64, moduli=mods)
    ctx_big, _, bk_big, _ = keys(p_big, 2)
    cases = [
        ("exact", p64, ctx64, bk64, 0, None),
        ("prune=1", p64, ctx64, bk64, 1, None),
        ("prune=2", p64, ctx64, bk64, 2, None),
        ("randomized", p64, ctx64, bk64, 0, SEED2),
        ("randomized prune=1", p64, ctx64, bk64, 1, SEED2),
        ("near-2^29 l=3", p_big, ctx_big, bk_big, 0, None),
    ]
    reset()
    for name, params, ctx, bk, prune, seed2 in cases:
        ua, a0, b0 = rand_acc(params, 8, 3)
        with twin():
            want = tbs.blind_rotate(params, ctx, bk.hat, bk.hat_shoup, ua, a0, b0, seed2, prune)
        steps = fused.blind_rotate_steps(ctx, bk.hat, ua, a0, b0, seed2, prune)
        torch.cuda.synchronize()
        for w, g in zip(want, steps):
            if not torch.equal(w, g):
                fail(f"kernel != twin in mode {name}: "
                     f"{int((w != g).sum())} of {w.numel()} words differ")
        print(f"[2] kernel == twin bit for bit: {name}")
        # rotate_resident, one launch for all n steps, == its plain version,
        # the twin and the step pair on the same 8 gates
        plain = fused.blind_rotate_fused_plain(ctx, bk.hat, ua, a0, b0, seed2, prune)
        before = rcount()
        got = fused.blind_rotate_fused(ctx, bk.hat, ua, a0, b0, seed2, prune)
        torch.cuda.synchronize()
        if rcount() != before + 1:
            fail(f"[2] rotate_resident {name}: {rcount() - before} launches, expected 1")
        for ref_name, ref in (("plain", plain), ("twin", want), ("step pair", steps)):
            if not all(torch.equal(w, g) for w, g in zip(ref, got)):
                fail(f"[2] rotate_resident != {ref_name} in mode {name}")
        print(f"[2] rotate_resident == plain == twin == step pair bit for bit, one launch: "
              f"{name}")
    print(f"[2] launches (flatten_ntt_fwd, mac_rotate_ntt_inv): {counts()}; "
          f"rotate_resident: {rcount()}")
    phase_done("2")

    # ---- 2b. one step of each kernel at every supported shape ---------------
    n_checks = 0
    for L in (2, 3, 4):
        for m in (512, 1024, 2048, 4096, 8192, 16384, 32768):
            mods = primes.find_rns_primes(2 * m, 1 << (29 * L - 2), (1 << (29 * L - 1)) - 1, L)
            params = dataclasses.replace(T.Params.create(m // 8), moduli=mods)
            ctx = T.make_context(params, device=dev)
            rng = np.random.default_rng(L * m)
            p = np.array(mods, dtype=np.int64).reshape(L, 1)

            def canon(shape):
                return rng.integers(0, 1 << 30, shape) % p

            def on_card(a):
                return mm.bits32(torch.as_tensor(a, device=dev))

            key_hat = on_card(canon((1, 2 * L, 2, L, m)))
            for prune in range(L):
                ragged = next((B for B in range(2, 200)
                               if (g := fused.mac_plan(B, L, m, prune).gates) > 1 and B % g), 2)
                for B in (1, ragged):
                    acc = on_card(canon((2, B, L, m)))
                    u = on_card(rng.integers(0, 2 * m, (B,)))
                    for seed2 in (None, SEED2):
                        got = fused.flatten_ntt_fwd(ctx, acc, 3, seed2, prune)
                        d_p = fused.flatten_ntt_fwd_plain(ctx, acc, 3, seed2, prune)
                        if not torch.equal(got, d_p):
                            fail(f"flatten_ntt_fwd != plain: L={L} m={m} B={B} "
                                 f"prune={prune} randomized={seed2 is not None}")
                        n_checks += 1
                    got = fused.mac_rotate_ntt_inv(ctx, d_p, key_hat, 0, u, prune)
                    if not torch.equal(got, fused.mac_rotate_ntt_inv_plain(ctx, d_p, key_hat,
                                                                           0, u, prune)):
                        fail(f"mac_rotate_ntt_inv != plain: L={L} m={m} B={B} prune={prune}")
                    n_checks += 1
            print(f"[2b] L={L} m={m}: both kernels == plain bit for bit "
                  f"(B = 1 and {ragged}, every prune and mode)")
    print(f"[2b] {n_checks} single-step checks")
    # rotate_resident at every (L, l = L, m) whose key the route admits (n = 64
    # steps, the least n of both schemes), near-2^29 moduli, random canonical
    # key and inputs, B = 1 and a batch whose last gate tile is partial
    n_res = 0
    admitted = [(L, m) for L in (2, 3, 4) for m in (512, 1024, 2048)
                if 32 * 64 * L * L * m <= tbs._RESIDENT_KEY_BYTES]
    for L, m in admitted:
        mods = primes.find_rns_primes(2 * m, 1 << (29 * L - 2), (1 << (29 * L - 1)) - 1, L)
        params = dataclasses.replace(T.Params.create(m // 8), moduli=mods)
        ctx = T.make_context(params, device=dev)
        rng = np.random.default_rng(7 * L + m)
        p = np.array(mods, dtype=np.int64).reshape(L, 1)
        key_hat = mm.bits32(torch.as_tensor(rng.integers(0, 1 << 30, (64, 2 * L, 2, L, m)) % p,
                                            device=dev))
        sm = fused._sm_count(0)
        for prune in range(L):
            ragged = next(B for B in range(2, 4096)
                          if (g := fused.resident_plan(B, L, L, m, prune, sm).gates) > 1
                          and B % g)
            for B in (1, ragged):
                ua = torch.as_tensor(rng.integers(0, 2 * m, (B, 64)), device=dev)
                a0 = torch.as_tensor(rng.integers(0, 1 << 30, (B, L, m)) % p, device=dev)
                b0 = torch.as_tensor(rng.integers(0, 1 << 30, (B, L, m)) % p, device=dev)
                for seed2 in (None, SEED2):
                    got = fused.blind_rotate_fused(ctx, key_hat, ua, a0, b0, seed2, prune)
                    refs = [fused.blind_rotate_fused_plain(ctx, key_hat, ua, a0, b0, seed2, prune),
                            fused.blind_rotate_steps(ctx, key_hat, ua, a0, b0, seed2, prune)]
                    for ref in refs:
                        if not all(torch.equal(w, g_) for w, g_ in zip(ref, got)):
                            fail(f"[2b] rotate_resident != plain or step pair: L={L} m={m} "
                                 f"B={B} prune={prune} randomized={seed2 is not None}")
                    n_res += 1
        print(f"[2b] L={L} m={m}: rotate_resident == plain == step pair bit for bit "
              f"(B = 1 and {ragged} at prune {L - 1}, every prune, both modes)")
    print(f"[2b] {n_res} whole-rotation checks at (L, m) in {admitted}")
    phase_done("2b")

    # ---- 3. each kernel against its plain version at main-path shapes -------
    p512 = T.Params.create(512)
    ctx512, sk512, bk512, g512 = keys(p512, 4)
    key_mib = 2 * bk512.hat.numel() * 4 / 2**20
    print(f"[3] Params(512) key with Shoup companions on the card: {key_mib:.0f} MiB")
    # scheme 2 at the paper's k = 1, n = 1024: context and keys on the card
    t = time.perf_counter()
    s2p = S2.Params.create(1)
    ctx2 = S2.make_context(s2p, device=dev)
    g2 = torch.Generator().manual_seed(6)
    sk2 = S2.PrivateKey.create(s2p, g2, device=dev)
    bk2 = S2.BootstrapKey.create(ctx2, sk2, g2)
    torch.cuda.synchronize()
    key_mib = 2 * bk2.hat.numel() * 4 / 2**20
    print(f"[3] scheme 2 k=1 n=1024: r={s2p.r} m={s2p.m} L={s2p.num_limbs} "
          f"q_moduli={s2p.q_moduli}; key with Shoup companions made on the card in "
          f"{time.perf_counter() - t:.1f} s: {key_mib:.0f} MiB")
    table = []
    # (tag, ..., batch, the TPU kernel replaced: _rotate_kernel at
    # Params(64); _rotate_step_kernel at Params(512) and for scheme 2's 2048
    # lanes)
    shapes = [
        ("n=64", p64, ctx64, bk64, 4096, "sgfhe_tpu/ops/fused.py:542"),
        ("n=512", p512, ctx512, bk512, 256, "sgfhe_tpu/ops/fused.py:604"),
        ("s2 k=1", s2p, ctx2, bk2, 2 * s2p.n, "sgfhe_tpu/ops/fused.py:604"),
    ]

    def add_row(phase, name, replaces, err, ms, pms, nbytes_muls,
                source="sgfhe_tpu_torch/csrc/rotate.cu"):
        bms, by = bound(*nbytes_muls)
        table.append(dict(
            name=name, route="cuda", source=source,
            replaces=replaces, launches=0, max_abs_err=err, ms=ms,
            plain_ms=pms, bound_ms=bms, bound_by=by, library_ms=None,
        ))
        print(f"[{phase}] {name}: {ms:.4f} ms/launch ({ms / bms:.1f}x bound), plain "
              f"{pms:.3f} ms, bound {bms:.4f} ms ({by}), max_abs_err {err}")

    def time_kernels(tag, params, ctx, bk, B, replaces, phase="3", reps=None):
        """Each kernel at one main path's shape, the forward kernel exact and
        randomized: == plain, ms per launch (over `reps` launches, n by
        default, walking the key's steps 0..n-1 in turn at a stride of n /
        reps), plain ms, bound; one table row each."""
        L, m, n = params.num_limbs, params.m, params.n
        reps = reps or n
        stride = n // reps
        ua, a0, b0 = rand_acc(params, B, 5)
        acc = torch.stack([a0, b0]).to(torch.int32).contiguous()
        u = ua[:, 0].to(torch.int32).contiguous()
        print(f"[{phase}] {tag}: B={B}, plans {fused.fwd_plan(B, L, m, 0, fused._sm_count(0))}, "
              f"{fused.mac_plan(B, L, m, 0, fused._sm_count(0))}")
        d_k = None
        for seed2 in (None, SEED2):
            got = fused.flatten_ntt_fwd(ctx, acc, 0, seed2)
            want = fused.flatten_ntt_fwd_plain(ctx, acc, 0, seed2)
            torch.cuda.synchronize()
            err = int((got.long() - want.long()).abs().max())
            if err:
                fail(f"{tag}: flatten_ntt_fwd vs plain max_abs_err {err}")
            d_k = got if seed2 is None else d_k
            ms = cuda_ms(lambda i: fused.flatten_ntt_fwd(ctx, acc, i * stride % n, seed2), reps)
            pms = cuda_ms(lambda i: fused.flatten_ntt_fwd_plain(ctx, acc, i % n, seed2), 3)
            name = f"flatten_ntt_fwd{' randomized' if seed2 else ''} ({tag})"
            add_row(phase, name, replaces, err, ms, pms, fwd_cost(B, L, m, L, seed2 is not None))
        out_k = fused.mac_rotate_ntt_inv(ctx, d_k, bk.hat, 0, u)
        out_p = fused.mac_rotate_ntt_inv_plain(ctx, d_k, bk.hat, 0, u)
        torch.cuda.synchronize()
        err = int((out_k.long() - out_p.long()).abs().max())
        if err:
            fail(f"{tag}: mac_rotate_ntt_inv vs plain max_abs_err {err}")
        ms = cuda_ms(lambda i: fused.mac_rotate_ntt_inv(ctx, d_k, bk.hat, i * stride % n, u),
                     reps)
        pms = cuda_ms(lambda i: fused.mac_rotate_ntt_inv_plain(ctx, d_k, bk.hat, i % n, u), 3)
        add_row(phase, f"mac_rotate_ntt_inv ({tag})", replaces, err, ms, pms,
                mac_cost(B, L, m, L))

    for shape in shapes:
        time_kernels(*shape)

    def once_ms(fn):
        """fn() once, its result and its ms by CUDA events."""
        start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        out = fn()
        stop.record()
        torch.cuda.synchronize()
        return out, start.elapsed_time(stop)

    # rotate_resident at Params(64), B = 4096, the main path's shape, in each
    # mode: == plain, ms a launch (a whole rotation), the plain version's
    # ms, the bound over the whole loop
    print(f"[3] rotate_resident registers and spills: "
          f"{ptxas_entry(ptxas_text, 'rotate_resident_kernel')}")
    L, m, n = p64.num_limbs, p64.m, p64.n
    ua, a0, b0 = rand_acc(p64, 4096, 5)
    sm = fused._sm_count(0)
    res_modes = [("exact", 0, None), ("randomized", 0, SEED2), ("prune=1", 1, None),
                 ("prune=2", 2, None)]
    res_ms = {}
    for mode, prune, seed2 in res_modes:
        plan = fused.resident_plan(4096, L, L, m, prune, sm)
        got = fused.blind_rotate_fused(ctx64, bk64.hat, ua, a0, b0, seed2, prune)
        want, pms = once_ms(lambda: fused.blind_rotate_fused_plain(
            ctx64, bk64.hat, ua, a0, b0, seed2, prune))
        err = max(int((w - g).abs().max()) for w, g in zip(want, got))
        if err:
            fail(f"[3] rotate_resident {mode} vs plain max_abs_err {err}")
        ms = cuda_ms(lambda i: fused.blind_rotate_fused(ctx64, bk64.hat, ua, a0, b0, seed2,
                                                        prune), 3)
        res_ms[mode] = ms
        print(f"[3] rotate_resident {mode} (n=64): plan {plan}")
        add_row("3", f"rotate_resident {mode} (n=64)", "sgfhe_tpu/ops/fused.py:542", err, ms,
                pms, resident_cost(4096, L, m, n, L - prune, seed2 is not None, prune == 0),
                source="sgfhe_tpu_torch/csrc/rotate_resident.cu")
    # every tile size that fits, exact: the plan's choice against the others
    sweep = []
    for G in range(1, fused.SMEM_BLOCK // fused.resident_gate_bytes(L, m, 0) + 1):
        ms = cuda_ms(lambda i: fused.blind_rotate_fused(ctx64, bk64.hat, ua, a0, b0,
                                                        gates=G), 3)
        sweep.append((G, round(ms, 4)))
    print(f"[3] rotate_resident exact (n=64) ms by gates a block (G, ms): {sweep}; the plan "
          f"takes G = {fused.resident_plan(4096, L, L, m, 0, sm).gates}")
    # the step pair on the same batch, all n steps
    ms = cuda_ms(lambda i: fused.blind_rotate_steps(ctx64, bk64.hat, ua, a0, b0), 3)
    print(f"[3] the step pair's whole rotation on the same 4096 gates: {ms:.4f} ms, "
          f"{2 * n} launches; rotate_resident exact {res_ms['exact']:.4f} ms, one launch")
    del ua, a0, b0, want, got

    def check_steps(phase, tag, params, ctx, bk, batches, prune=0):
        """One step of each kernel, bit for bit against plain, exact and
        randomized, at each batch in `batches`."""
        L, m = params.num_limbs, params.m
        for B in batches:
            ua, a0, b0 = rand_acc(params, B, 7 + B)
            acc = torch.stack([a0, b0]).to(torch.int32).contiguous()
            u = ua[:, 1].to(torch.int32).contiguous()
            for seed2 in (None, SEED2):
                mode = "randomized" if seed2 else "deterministic"
                d_p = fused.flatten_ntt_fwd_plain(ctx, acc, 1, seed2, prune)
                if not torch.equal(fused.flatten_ntt_fwd(ctx, acc, 1, seed2, prune), d_p):
                    fail(f"{tag} B={B} prune={prune}: flatten_ntt_fwd != plain ({mode})")
                if not torch.equal(fused.mac_rotate_ntt_inv(ctx, d_p, bk.hat, 1, u, prune),
                                   fused.mac_rotate_ntt_inv_plain(ctx, d_p, bk.hat, 1, u, prune)):
                    fail(f"{tag} B={B} prune={prune}: mac_rotate_ntt_inv != plain ({mode})")
            sm = fused._sm_count(0)
            print(f"[{phase}] {tag} B={B} prune={prune}: both kernels == plain bit for bit at "
                  f"step 1 (deterministic and randomized; plans "
                  f"{fused.fwd_plan(B, L, m, prune, sm)}, {fused.mac_plan(B, L, m, prune, sm)})")

    # The launch plans (gate tile, chunks, waves) follow B, so every other
    # batch a main path launches is held against plain too: mul's rounds of
    # 4, 2 and 1 lanes a pair on 256 pairs, and pack_encrypted_bits' 512
    # trivial bootstraps at Params(512).
    check_steps("3", "s2 k=1", s2p, ctx2, bk2, (1024, 512, 256))
    check_steps("3", "n=512", p512, ctx512, bk512, (512,))
    phase_done("3")

    # ---- 3s. the exact Q->r switch's kernel at the main paths' shapes --------
    print(f"[3s] rescale registers and spills: {ptxas_entry(ptxas_text, 'rescale_exact_kernel')}")
    switch_table = switch_rows()
    phase_done("3s")

    # ---- 4/5. the main path --------------------------------------------------
    def truth_tables(sk, out, y1, y2):
        for gate, lwe, want in zip(("AND", "OR", "XOR"), out, (y1 & y2, y1 | y2, y1 ^ y2)):
            got = T.decrypt_bit(sk, T.EncryptedBit(lwe))
            if got.shape != want.shape or not torch.equal(got, want):
                fail(f"{gate} truth table: {int((got != want).sum())} wrong gates")
            if not (lwe.a.max() < sk.params.r and lwe.a.min() >= 0):
                fail(f"{gate}: output out of range")

    def timed(tag, call, reps, warm=True):
        """One warm call (unless the caller has just made one) and `reps`
        timed ones (host clock, synchronized), with the launch counts set to
        0 just before and read just after."""
        reset()
        times = []
        for i in range(reps + int(warm)):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = call()
            torch.cuda.synchronize()
            if i or not warm:
                times.append(time.perf_counter() - t)
        launches = counts()
        if not (all(launches) or rcount()):
            fail(f"[{tag}] no rotation kernel was launched: step pair {launches}, "
                 f"rotate_resident {rcount()}")
        return out, launches, statistics.median(times), times

    def timed_s(fn, *args):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn(*args)
        torch.cuda.synchronize()
        return out, time.perf_counter() - t

    rates = {}  # gates/s of each phase's drive

    def drive(tag, params, ctx, bk, sk, lwe1, lwe2, y1, y2, reps):
        B = lwe1.a.shape[0]

        def call():
            return T.bootstrap_batch(params, ctx, bk.hat, bk.hat_shoup, lwe1, lwe2)

        out, launches, med, times = timed(tag, call, reps)
        truth_tables(sk, out, y1, y2)
        what = expect_launches(tag, params, reps + 1)
        print(f"[{tag}] {B} gates, truth tables AND/OR/XOR hold; launches {what} over "
              f"{reps + 1} calls")
        rates[tag] = B / med
        print(f"[{tag}] {B / med:.1f} gates/s (median of {reps}: "
              f"{[round(t, 4) for t in times]} s) on {card}")
        return out, launches, trace(tag, call)

    def trace(tag, call):
        """Device busy time of one traced call, by the profiler's device
        events: each rotation kernel, the other device ops, and idle.
        Returns each rotation kernel's device ms per launch."""
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t = time.perf_counter()
            call()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t) * 1e3
        busy = 0.0
        kern = {"flatten_ntt_fwd": [0.0, 0], "mac_rotate_ntt_inv": [0.0, 0],
                "rotate_resident": [0.0, 0]}
        for e in prof.key_averages():
            if e.device_type != DeviceType.CUDA or getattr(e, "is_user_annotation", False):
                continue
            busy += e.self_device_time_total / 1e3
            for name, acc in kern.items():
                if f"{name}_kernel" in e.key:
                    acc[0] += e.self_device_time_total / 1e3
                    acc[1] += e.count
        rot = sum(ms for ms, _ in kern.values())
        steps = kern["flatten_ntt_fwd"][1] and kern["mac_rotate_ntt_inv"][1]
        if not (steps or kern["rotate_resident"][1]):
            fail(f"[{tag}] the trace misses the rotation kernels on the device: {kern}")
        kern = {name: v for name, v in kern.items() if v[1]}
        # the host's kernel launches (the CUDA runtime calls the profiler
        # records on the CPU side): the work the host issues a call
        launched = sum(e.count for e in prof.key_averages()
                       if e.key.startswith("cudaLaunchKernel"))
        print(f"[{tag}] trace of one call: {wall:.2f} ms wall, device busy {busy:.2f} ms "
              f"({busy / wall:.1%}): rotation kernels {rot:.2f} ms, other device ops "
              f"{busy - rot:.2f} ms; idle {wall - busy:.2f} ms ({1 - busy / wall:.1%}); "
              f"the host launched {launched} kernels")
        for name, (ms, n) in kern.items():
            print(f"[{tag}] trace: {name} {ms:.2f} ms over {n} launches "
                  f"({ms / n:.4f} ms/launch)")
        return {name: ms / n for name, (ms, n) in kern.items()}

    # Params(64): every pair (i, j) of two 64-bit messages -> 4096 gates
    m1 = torch.randint(0, 2, (p64.n,), generator=g64)
    m2 = torch.randint(0, 2, (p64.n,), generator=g64)
    e1 = T.split_ciphertext(T.encrypt(sk64, g64, m1)).lwe
    e2 = T.split_ciphertext(T.encrypt(sk64, g64, m2)).lwe
    ii = torch.arange(p64.n, device=dev).repeat_interleave(p64.n)
    jj = torch.arange(p64.n, device=dev).repeat(p64.n)
    lwe1, lwe2 = T.LWE(e1.a[ii], e1.b[ii]), T.LWE(e2.a[jj], e2.b[jj])
    y1, y2 = m1.to(dev)[ii].bool(), m2.to(dev)[jj].bool()

    def step_pair_call(seed2, prune):
        """bootstrap_batch's work on the same gates with the rotation through
        the step pair (2n launches), the route these gates took before
        rotate_resident."""
        def rotate(ua, a, b, seed2=None, prune=0):
            return fused.blind_rotate_steps(ctx64, bk64.hat, ua, a, b, seed2, prune)

        def call():
            triple = tbs.bootstrap_internal(p64, ctx64, bk64.hat, bk64.hat_shoup, lwe1.a,
                                            lwe1.b, lwe2.a, lwe2.b, seed2, prune, rotate=rotate)
            return tuple(tbs._reduce_lwe(p64, ctx64, t) for t in triple)

        return call

    # the main path in each mode through rotate_resident, alternating with the
    # step pair on the same 4096 gates: every output bit for bit the same,
    # truth tables, gates/s of both, launches a call (1 against 2n)
    l64, calls64 = {}, {}
    for mode, kw, prune in (("exact", {}, 0),
                            ("randomized", dict(seed_words=SEED2, epoch=0), 0),
                            ("prune=1", dict(prune=1), 1), ("prune=2", dict(prune=2), 2)):
        def res_call(kw=kw):
            return T.bootstrap_batch(p64, ctx64, bk64.hat, bk64.hat_shoup, lwe1, lwe2, **kw)

        st_call = step_pair_call(prg.fold_epoch(SEED2, 0) if kw.get("seed_words") else None,
                                 prune)
        reps = 5 if mode == "exact" else 2
        times, outs = {"rotate_resident": [], "step pair": []}, {}
        reset()
        for i in range(reps + 1):  # the first call of each route is its warm-up
            for route, call in (("rotate_resident", res_call), ("step pair", st_call)):
                torch.cuda.synchronize()
                t = time.perf_counter()
                outs[route] = call()
                torch.cuda.synchronize()
                if i:
                    times[route].append(time.perf_counter() - t)
        got_l = (counts(), rcount())
        if got_l != (((reps + 1) * p64.n,) * 2, reps + 1):
            fail(f"[4] {mode}: launches (step pair, rotate_resident) {got_l} over {reps + 1} "
                 f"calls of each route, expected 2n = {2 * p64.n} and 1 a call")
        l64[mode], calls64[mode] = rcount(), reps + 1
        for out in outs.values():
            truth_tables(sk64, out, y1, y2)
        if not all(torch.equal(x.a, y.a) and torch.equal(x.b, y.b)
                   for x, y in zip(outs["rotate_resident"], outs["step pair"])):
            fail(f"[4] {mode}: rotate_resident's outputs != the step pair's")
        med = {r: statistics.median(t) for r, t in times.items()}
        print(f"[4] {mode}: 4096 gates, truth tables AND/OR/XOR hold through both routes, "
              f"outputs equal bit for bit; launches a call: rotate_resident 1, step pair "
              f"{2 * p64.n} (flatten_ntt_fwd and mac_rotate_ntt_inv {p64.n} each)")
        for route, t in times.items():
            print(f"[4] {mode} {route}: {4096 / med[route]:.1f} gates/s (median of {reps}: "
                  f"{[round(x, 4) for x in t]} s, alternating) on {card}")
        if mode == "exact":
            rates["4"] = 4096 / med["rotate_resident"]
            print("[4] exact, rotate_resident, traced:")
            tr64 = trace("4", res_call)
            print("[4] exact, step pair, traced:")
            trace("4", st_call)
    phase_done("4")

    # Params(512): every pair (2i, 2i+1) of one 512-bit message -> 256 gates
    msg = torch.randint(0, 2, (p512.n,), generator=g512)
    bits = T.split_ciphertext(T.encrypt(sk512, g512, msg)).lwe
    lwe1 = T.LWE(bits.a[0::2], bits.b[0::2])
    lwe2 = T.LWE(bits.a[1::2], bits.b[1::2])
    y1, y2 = msg.to(dev)[0::2].bool(), msg.to(dev)[1::2].bool()
    out, l512, tr512 = drive("5", p512, ctx512, bk512, sk512, lwe1, lwe2, y1, y2, reps=2)
    torch.cuda.synchronize()
    t = time.perf_counter()
    with twin():
        twin_out = T.bootstrap_batch(p512, ctx512, bk512.hat, bk512.hat_shoup, lwe1, lwe2)
    torch.cuda.synchronize()
    twin_s = time.perf_counter() - t
    for a, b in zip(out, twin_out):
        if not (torch.equal(a.a, b.a) and torch.equal(a.b, b.b)):
            fail("Params(512): kernel path != twin on the card")
    print(f"[5] twin on the card, same 256 gates: {twin_s:.2f} s "
          f"({256 / twin_s:.1f} gates/s); output equal to the kernels' bit for bit")
    print(f"[5] peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")

    phase_done("5")

    # ---- 6. scheme 2 at the paper's k = 1, n = 1024 ---------------------------
    n2 = s2p.n
    route = tbs._rotation_route(s2p, dev)
    if route != "wmul":
        fail(f"[6] scheme 2 k=1 takes route {route}, expected wmul")
    print(f"[6] scheme 2 k=1 n=1024: rotation route {route}")

    def digits_noise(tag, sk, lwe, want):
        """Decrypt a digit batch against `want`; its max |phase noise|."""
        params = sk.params
        got = B2.decrypt_lwe(sk, lwe)
        want = torch.as_tensor(want, device=dev)
        if got.shape != want.shape or not torch.equal(got, want):
            fail(f"[{tag}] {int((got != want).sum())} of {want.numel()} digits wrong")
        noise_ = int(B2.lwe_phase_noise(sk, lwe, want).abs().max())
        if noise_ >= params.Dr // 4:
            fail(f"[{tag}] phase noise {noise_} >= Dr/4 = {params.Dr // 4}")
        return noise_

    def twin_ops(tag, params, ctx, bk, sx, sy):
        """add_with_carry and mul on a few pairs through the kernels equal to
        the twin's output bit for bit, deterministic and randomized (add:
        the seed words given; mul: each round its own split pair)."""
        for seed2 in (None, SEED2):
            t = time.perf_counter()
            with twin():
                want = B2._add_with_carry(params, ctx, bk, sx, sy, None, seed2)
            torch.cuda.synchronize()
            twin_s = time.perf_counter() - t
            reset()
            got = B2._add_with_carry(params, ctx, bk, sx, sy, None, seed2)
            what = expect_launches(tag, params, 1)
            for w, g in zip(want, got):
                if not (torch.equal(w.a, g.a) and torch.equal(w.b, g.b)):
                    fail(f"[{tag}] add_with_carry kernels != twin, randomized={seed2 is not None}")
            print(f"[{tag}] add_with_carry on {sx.a.shape[0]} pairs at k={params.k}, "
                  f"n={params.n}, {'randomized (seed words given)' if seed2 else 'deterministic'}"
                  f": kernels' output == twin's bit for bit (twin {twin_s:.2f} s on the card); "
                  f"launches {what}")
        for seeds in ((None,) * 3, tuple(prg.split_words(SEED2, 3))):
            t = time.perf_counter()
            with twin():
                want = B2._mul(params, ctx, bk, sx, sy, seeds)
            torch.cuda.synchronize()
            twin_s = time.perf_counter() - t
            reset()
            got = B2._mul(params, ctx, bk, sx, sy, seeds)
            what = expect_launches(tag, params, 3)
            for w, g in zip(want, got):
                if not (torch.equal(w.a, g.a) and torch.equal(w.b, g.b)):
                    fail(f"[{tag}] mul kernels != twin, randomized={seeds[0] is not None}")
            print(f"[{tag}] mul on {sx.a.shape[0]} pairs at k={params.k}, n={params.n}, "
                  f"{'randomized (split seed words)' if seeds[0] else 'deterministic'}: "
                  f"kernels' output == twin's bit for bit (twin {twin_s:.2f} s on the card); "
                  f"launches {what}")

    def s2_keys(tag, k, seed):
        """Scheme 2 at k, n = 1024: context and keys made on the card after a
        free-memory check; the key's build seconds."""
        params = S2.Params.create(k)
        ctx = S2.make_context(params, device=dev)
        key_bytes = fused.fused_bkey_bytes(params)
        free = torch.cuda.mem_get_info()[0]
        if free < key_bytes + 8 * KEY_CHUNK_BYTES:
            fail(f"[{tag}] k={k}: {free / 2**30:.1f} GiB free, the key needs "
                 f"{key_bytes / 2**30:.1f} GiB and its build's chunks")
        g = torch.Generator().manual_seed(seed)
        sk = S2.PrivateKey.create(params, g, device=dev)
        bk, s_key = timed_s(S2.BootstrapKey.create, ctx, sk, g)
        print(f"[{tag}] k={k}: r={params.r} m={params.m} L={params.num_limbs} "
              f"q_moduli={params.q_moduli}; key with Shoup companions made on the card in "
              f"{s_key:.1f} s: {2 * bk.hat.numel() * 4 / 2**20:.0f} MiB "
              f"({free / 2**30:.1f} GiB free before)")
        return params, ctx, sk, bk, g

    def s2_pairs(params, sk, g, pairs):
        """`pairs` digit pairs encrypted and split, and their plaintexts."""
        K = 2**params.k
        x = torch.randint(0, K, (params.n,), generator=g)
        y = torch.randint(0, K, (params.n,), generator=g)
        lx = B2.split_ciphertext(params, *S2.encrypt(sk, g, x))
        ly = B2.split_ciphertext(params, *S2.encrypt(sk, g, y))
        return (T.LWE(lx.a[:pairs], lx.b[:pairs]), T.LWE(ly.a[:pairs], ly.b[:pairs]),
                x[:pairs].to(dev), y[:pairs].to(dev))

    def s2_add(tag, params, ctx, bk, sk, lx, ly, z, reps, rounds=1, warm=True, **kw):
        """add_with_carry (or with `rounds` = 3, mul) timed over `reps` calls
        after a warm one (`warm`=False: the caller made it): every digit
        right, launches 2n a rotation round; returns the launch counts."""
        K, n = 2**params.k, params.n
        fn = B2.mul if rounds == 3 else B2.add_with_carry
        (lo, hi), launches, med, times = timed(tag, lambda: fn(params, ctx, bk, lx, ly, **kw),
                                               reps, warm)
        what = "mul" if rounds == 3 else "add_with_carry"
        noise_ = max(digits_noise(f"{tag} k={params.k} {what} low", sk, lo, z % K),
                     digits_noise(f"{tag} k={params.k} {what} high", sk, hi, z // K))
        calls = reps + int(warm)
        expect_launches(tag, params, calls * rounds)
        pairs = lx.a.shape[0]
        mode = ("randomized" if "seed_words" in kw
                else ", ".join(f"{k_}={v}" for k_, v in kw.items()) or "exact")
        print(f"[{tag}] k={params.k} {what} ({mode}) on {pairs} pairs: every "
              f"{'low and high digit' if rounds == 3 else 'digit and carry'} right, max "
              f"|phase noise| {noise_} (Dr = {params.Dr}); launches {launches} over "
              f"{calls} calls, 2n = {2 * n} a rotation round")
        print(f"[{tag}] k={params.k} {what} ({mode}): {pairs / med:.1f} a second (median of "
              f"{reps}: {[round(t, 4) for t in times]} s) on {card}")
        return launches

    lx, ly, x, y = s2_pairs(s2p, sk2, g2, n2)
    l_add = s2_add("6", s2p, ctx2, bk2, sk2, lx, ly, x + y, 2)
    Bm = 256  # mul's rounds: 1024, 512 and 256 lanes
    mx, my = T.LWE(lx.a[:Bm], lx.b[:Bm]), T.LWE(ly.a[:Bm], ly.b[:Bm])
    s2_add("6", s2p, ctx2, bk2, sk2, mx, my, x[:Bm] * y[:Bm], 2, rounds=3)
    tr_s2 = trace("6", lambda: B2.add_with_carry(s2p, ctx2, bk2, lx, ly))
    # whole ops against the twin at the toy n = 64 (k = 1; phase 12 at n = 1024)
    toy = S2.Params.create(1, 64)
    ctx_t = S2.make_context(toy, device=dev)
    sk_t = S2.PrivateKey.create(toy, g2, device=dev)
    bk_t = S2.BootstrapKey.create(ctx_t, sk_t, g2)
    tx = B2.split_ciphertext(toy, *S2.encrypt(sk_t, g2, torch.arange(toy.n) % 2))
    ty = B2.split_ciphertext(toy, *S2.encrypt(sk_t, g2, torch.arange(toy.n) // 2 % 2))
    twin_ops("6", toy, ctx_t, bk_t, T.LWE(tx.a[:4], tx.b[:4]), T.LWE(ty.a[:4], ty.b[:4]))
    phase_done("6")

    # ---- 7. the rest of scheme 1's API at Params(512) ------------------------
    pk512 = T.PublicKey.create(ctx512, sk512, g512)
    msg = torch.randint(0, 2, (p512.n,), generator=g512)
    bits = T.split_ciphertext(T.encrypt(pk512, ctx512, g512, msg)).lwe
    lwe1, lwe2 = T.LWE(bits.a[0::2], bits.b[0::2]), T.LWE(bits.a[1::2], bits.b[1::2])
    y1, y2 = msg.to(dev)[0::2].bool(), msg.to(dev)[1::2].bool()
    gates = T.bootstrap_batch(p512, ctx512, bk512.hat, bk512.hat_shoup, lwe1, lwe2)
    truth_tables(sk512, gates, y1, y2)
    print(f"[7] public key: 512 bits encrypted, split, 256 gates bootstrapped; truth "
          f"tables AND/OR/XOR hold")
    for name, key_args in (("private", (sk512,)), ("public", (pk512, ctx512))):
        opt = T.encrypt_optimal(*key_args, g512, msg)
        if not torch.equal(T.decrypt(sk512, T.normalize_ciphertext(opt)), msg.to(dev).bool()):
            fail(f"[7] {name} space-optimal round trip decrypts wrong")
    print("[7] encrypt_optimal -> normalize_ciphertext -> decrypt right for both key types")
    # 512 bootstrapped bits: the AND and XOR outputs of the 256 gates
    g_and, _, g_xor = gates
    packed_in = T.EncryptedBit(T.LWE(torch.cat([g_and.a, g_xor.a]), torch.cat([g_and.b, g_xor.b])))
    want = torch.cat([y1 & y2, y1 ^ y2])
    packed, l_pack, med, times = timed(
        "7", lambda: T.pack_encrypted_bits(p512, ctx512, bk512, packed_in), 3)
    if l_pack != (4 * p512.n, 4 * p512.n):
        fail(f"[7] pack_encrypted_bits launches {l_pack}, expected 2n per call")
    for mode, ct in (("deterministic", packed), ("randomized", T.pack_encrypted_bits(
            p512, ctx512, bk512, packed_in, SEED2))):
        if ct.rlwe.a.shape != (p512.m,) or not torch.equal(T.decrypt(sk512, ct), want):
            fail(f"[7] pack_encrypted_bits ({mode}): the length-m ciphertext decrypts wrong")
    print(f"[7] pack_encrypted_bits of 512 bootstrapped bits -> length-{p512.m} Ciphertext, "
          f"every bit right (deterministic and randomized); launches = {l_pack} over 4 calls")
    print(f"[7] pack_encrypted_bits: {med:.4f} s (median of 3: {[round(t, 4) for t in times]} "
          f"s) on {card}")
    # the same 512 bits through the twin, with the bootstraps' and the pack
    # stage's seed words given: both mask streams, not just the decryption
    for seeds in ((None, None), tuple(prg.split_words(SEED2, 2))):
        t = time.perf_counter()
        with twin():
            want = tbs.pack_internal(p512, ctx512, bk512.hat, bk512.hat_shoup, packed_in.lwe,
                                     *seeds)
        torch.cuda.synchronize()
        twin_s = time.perf_counter() - t
        got = tbs.pack_internal(p512, ctx512, bk512.hat, bk512.hat_shoup, packed_in.lwe, *seeds)
        if not (torch.equal(want.a, got.a) and torch.equal(want.b, got.b)):
            fail(f"[7] pack_internal kernels != twin, randomized={seeds[0] is not None}")
        print(f"[7] pack_internal, {'randomized (split seed words)' if seeds[0] else 'deterministic'}"
              f": kernels' output == twin's bit for bit (twin {twin_s:.2f} s on the card)")
    print(f"[7] peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    phase_done("7")

    # ---- 8. the boolean-circuit layer at Params(512) --------------------------
    def encrypt_bits(params, sk, g, bits):
        """(count, B) bits -> `count` EncryptedBit batches of B; n bits an
        encryption."""
        flat = bits.reshape(-1)
        parts = []
        for i in range(0, flat.numel(), params.n):
            chunk = flat[i:i + params.n]
            msg = torch.zeros(params.n, dtype=torch.int64)
            msg[:chunk.numel()] = chunk
            e = T.split_ciphertext(T.encrypt(sk, g, msg)).lwe
            parts.append((e.a[:chunk.numel()], e.b[:chunk.numel()]))
        a, b = (torch.cat(x) for x in zip(*parts))
        B = bits.shape[1]
        return [T.EncryptedBit(T.LWE(a[i * B:(i + 1) * B], b[i * B:(i + 1) * B]))
                for i in range(bits.shape[0])]

    def circuit_right(tag, sk, circ, bits, outs):
        """Every output bit of every instance against evaluate_plain."""
        want = torch.tensor([C.evaluate_plain(circ, bits[:, j].tolist())
                             for j in range(bits.shape[1])]).t().to(dev)
        for i, o in enumerate(outs):
            got = T.decrypt_bit(sk, o).long()
            if got.shape != want[i].shape or not torch.equal(got, want[i]):
                fail(f"[8] {tag}: output {i}: {int((got != want[i]).sum())} wrong instances")
        return want

    def level_batches(circ, B):
        """The padded batch of every level of `circ` on B instances."""
        return sorted({1 << (len(lv) * B - 1).bit_length() for lv in circ.schedule() if lv})

    Bc = 64
    batches8 = set()
    for name, circ, unit in (("ripple_adder(16)", C.ripple_adder(16), "additions"),
                             ("comparator(16)", C.comparator(16), "comparisons")):
        levels = sum(1 for lv in circ.schedule() if lv)
        bits = torch.randint(0, 2, (circ.num_inputs, Bc), generator=g512)
        ins = encrypt_bits(p512, sk512, g512, bits)
        outs, launches, med, times = timed(
            "8", lambda: C.evaluate(circ, p512, ctx512, bk512, ins), 1)
        want = circuit_right(name, sk512, circ, bits, outs)
        if launches != (2 * levels * p512.n,) * 2:
            fail(f"[8] {name}: launches {launches}, expected 2n a level")
        circuit_right(name + " randomized", sk512, circ, bits,
                      C.evaluate(circ, p512, ctx512, bk512, ins, SEED2))
        batches8.update(level_batches(circ, Bc))
        print(f"[8] {name} on {Bc} instances: {levels} levels, {circ.num_bootstraps} "
              f"bootstraps an instance, every output bit right (deterministic and "
              f"randomized); launches {launches} over 2 evaluations, {2 * p512.n} a level "
              f"({2 * levels * p512.n} an evaluation)")
        print(f"[8] {name}: {med:.4f} s an evaluation (one timed after one warm: "
              f"{[round(t, 4) for t in times]} s), {Bc / med:.1f} {unit}/s on {card}")
        if unit == "additions":
            err = noise_dbg.noise_budget_report(sk512, T.EncryptedBit(T.LWE(
                torch.cat([o.lwe.a for o in outs]), torch.cat([o.lwe.b for o in outs]))),
                want.reshape(-1))
            if not err["ok"]:
                fail(f"[8] {name}: output noise beyond Dr/2: {err}")
            print(f"[8] noise of the adder's {len(outs) * Bc} output bits: max |error| "
                  f"{err['max_abs']}, mean {err['mean_abs']:.2f}, against Dr/2 = "
                  f"{err['boundary']}: {err['headroom_bits']:.2f} bits of headroom")
            # 30 of the adder's 31 levels are one pair: one such level traced
            print(f"[8] a one-pair level ({Bc} lanes), traced:")
            trace("8", lambda: T.bootstrap_batch(p512, ctx512, bk512.hat, bk512.hat_shoup,
                                                 ins[0].lwe, ins[len(ins) // 2].lwe))
    check_steps("8", "n=512", p512, ctx512, bk512, sorted(batches8 - {256, 512}))
    # at Params(64) (the carried T-term): the kernels' evaluation == plain's
    circ = C.ripple_adder(8)
    bits = torch.randint(0, 2, (circ.num_inputs, 4), generator=g64)
    ins = encrypt_bits(p64, sk64, g64, bits)
    levels = len(circ.schedule())
    for seeds in (None, prg.split_words(SEED2, levels)):
        t = time.perf_counter()
        with twin():
            want = C.evaluate_internal(circ, p64, ctx64, bk64, ins, seeds)
        torch.cuda.synchronize()
        twin_s = time.perf_counter() - t
        reset()
        with CountRotations() as rot8:
            got = C.evaluate_internal(circ, p64, ctx64, bk64, ins, seeds)
        what = expect_launches("8", p64, rot8.n)
        for w, g in zip(want, got):
            if not (torch.equal(w.lwe.a, g.lwe.a) and torch.equal(w.lwe.b, g.lwe.b)):
                fail(f"[8] ripple_adder(8) kernels != plain, randomized={seeds is not None}")
        circuit_right("ripple_adder(8)", sk64, circ, bits, got)
        print(f"[8] Params(64) ripple_adder(8) on 4 instances, "
              f"{'randomized (seed words given per level)' if seeds else 'deterministic'}: "
              f"kernels' output == plain's bit for bit, every bit right (plain {twin_s:.2f} s); "
              f"{rot8.n} rotations, launches {what}")
    phase_done("8")

    # ---- 9. wide integers at scheme 2's k = 1, n = 1024 ------------------------
    def wide_right(name, sk, digits, want):
        """Every digit of a wide result against numpy; max |phase noise|."""
        k = sk.params.k
        if not np.array_equal(WI.decrypt_wide(sk, digits), want):
            fail(f"[9] {name}: wrong values")
        return max(digits_noise(f"9 {name}", sk, d, (want >> (k * j)) & (2**k - 1))
                   for j, d in enumerate(digits))

    W9, B9 = 3, 64
    top = 2 ** (s2p.k * W9)
    rng = np.random.default_rng(9)
    xv, yv = rng.integers(0, top, B9), rng.integers(0, top, B9)
    yv[0] = xv[0]
    xv[1], yv[1], xv[2], yv[2] = 0, top - 1, top - 1, 0
    xs, ys = WI.encrypt_wide(sk2, g2, xv, W9), WI.encrypt_wide(sk2, g2, yv, W9)
    ge_v = (xv >= yv).astype(np.int64)
    mul_rot = 3 + WI._mul_wide_adds(W9)
    rates = {}
    # (name, call, rotations, the output as wide numbers, their values, timed calls)
    for name, call, rotations, numbers, want, reps in (
            ("add_wide", lambda: WI.add_wide(s2p, ctx2, bk2, xs, ys), W9, lambda o: [o],
             [xv + yv], 2),
            ("sub_wide", lambda: WI.sub_wide(s2p, ctx2, bk2, xs, ys), W9,
             lambda o: [o[0], [o[1]]], [(xv - yv) % top, ge_v], 2),
            ("mul_wide", lambda: WI.mul_wide(s2p, ctx2, bk2, xs, ys), mul_rot, lambda o: [o],
             [xv * yv], 1),
            ("min_max_wide", lambda: WI.min_max_wide(s2p, ctx2, bk2, xs, ys), W9 + 1, list,
             [np.minimum(xv, yv), np.maximum(xv, yv)], 2)):
        out, launches, med, times = timed("9", call, reps)
        if launches != ((reps + 1) * rotations * s2p.n,) * 2:
            fail(f"[9] {name}: launches {launches}, expected 2n a rotation")
        noise_ = max(wide_right(name, sk2, r, w) for r, w in zip(numbers(out), want))
        rates[name] = B9 / med
        print(f"[9] {name} on {B9} {W9}-digit pairs: every value right, max |phase noise| "
              f"{noise_} (Dr = {s2p.Dr}); {rotations} rotations, launches {launches} over "
              f"{reps + 1} calls; {med:.4f} s a call (median of {reps}: "
              f"{[round(t, 4) for t in times]} s), {B9 / med:.1f} a second on {card}")
    print(f"[9] subs/s {rates['sub_wide']:.1f}, wide muls/s {rates['mul_wide']:.1f}, "
          f"min+max/s {rates['min_max_wide']:.1f} (k=1, n=1024, W={W9}) on {card}")
    reset()
    flag = WI.ge_wide(s2p, ctx2, bk2, xs, ys)
    wide_right("select_wide", sk2, WI.select_wide(s2p, ctx2, bk2, flag, xs, ys),
               np.where(ge_v == 1, xv, yv))
    wide_right("eq_wide", sk2, [WI.eq_wide(s2p, ctx2, bk2, xs, ys)], (xv == yv).astype(np.int64))
    vals = rng.integers(0, top, (4, B9))
    items = [WI.encrypt_wide(sk2, g2, v, W9) for v in vals]
    for i, it in enumerate(WI.sort_wide(s2p, ctx2, bk2, items)):
        wide_right("sort_wide", sk2, it, np.sort(vals, axis=0)[i])
    d_r, ge_r = WI.sub_wide(s2p, ctx2, bk2, xs, ys, SEED2)
    wide_right("sub_wide randomized", sk2, d_r, (xv - yv) % top)
    wide_right("sub_wide randomized", sk2, [ge_r], ge_v)
    mn, mx = WI.min_max_wide(s2p, ctx2, bk2, xs, ys, SEED2)
    wide_right("min_max_wide randomized", sk2, mn, np.minimum(xv, yv))
    wide_right("min_max_wide randomized", sk2, mx, np.maximum(xv, yv))
    rot = W9 + (1 + 2 * W9 + 1) + 5 * (W9 + 1) + W9 + (W9 + 1)
    if counts() != (rot * s2p.n,) * 2:
        fail(f"[9] launches {counts()}, expected {rot} rotations of 2n")
    print(f"[9] select_wide, eq_wide, sort_wide of 4 x {B9} numbers (5 comparators), "
          f"randomized sub_wide and min_max_wide: every value right; launches {counts()}")
    # every batch these ops launch, one step of each kernel against plain
    check_steps("9", "s2 k=1", s2p, ctx2, bk2,
                (B9, 2 * B9, 2 * W9 * B9, W9 * W9 * B9, 4 * W9 * B9, 2 * W9 * W9 * B9,
                 4 * W9 * W9 * B9))
    # whole ops through the kernels against plain, with pinned seed words,
    # at the toy n = 64 (phase 6's key): min_max_wide, mul_wide (13 rotations)
    x2, y2 = np.array([3, 1]), np.array([2, 3])
    for name, params, ctx, bk, sk, fn, count, numbers, want in (
            ("min_max_wide (n=64)", toy, ctx_t, bk_t, sk_t, WI._min_max_wide, 3, list,
             [np.minimum(x2, y2), np.maximum(x2, y2)]),
            ("mul_wide (n=64)", toy, ctx_t, bk_t, sk_t, WI._mul_wide,
             3 + WI._mul_wide_adds(2), lambda o: [o], [x2 * y2])):
        a2, b2 = WI.encrypt_wide(sk, g2, x2, 2), WI.encrypt_wide(sk, g2, y2, 2)
        seeds = prg.split_words(SEED2, count)
        t = time.perf_counter()
        with twin():
            want_out = numbers(fn(params, ctx, bk, a2, b2, seeds))
        torch.cuda.synchronize()
        twin_s = time.perf_counter() - t
        reset()
        got = numbers(fn(params, ctx, bk, a2, b2, seeds))
        what = expect_launches("9", params, count)
        for w, g in zip(sum(want_out, []), sum(got, [])):
            if not (torch.equal(w.a, g.a) and torch.equal(w.b, g.b)):
                fail(f"[9] {name}: kernels != plain with pinned seed words")
        for r, w in zip(got, want):
            wide_right(name, sk, r, w)
        print(f"[9] {name}, W=2, B=2, {count} rotations with pinned seed words: kernels' "
              f"output == plain's bit for bit, values right (plain {twin_s:.2f} s); "
              f"launches {what}")
    phase_done("9")

    # ---- 10. scheme 2 at k = 2 and k = 4, n = 1024 ------------------------------
    del bk_t, ctx_t
    runs10 = {}
    for k, pairs, seed, steps_timed in ((2, 1024, 12, None), (4, 256, 14, 256)):
        pk, ctx_k, sk_k, bk_k, g_k = s2_keys("10", k, seed)
        lx, ly, x, y = s2_pairs(pk, sk_k, g_k, pairs)
        l_k = s2_add("10", pk, ctx_k, bk_k, sk_k, lx, ly, x + y, 1)
        tr_k = trace("10", lambda: B2.add_with_carry(pk, ctx_k, bk_k, lx, ly))
        top_k = 4**k
        xv_k, yv_k = rng.integers(0, top_k, 64), rng.integers(0, top_k, 64)
        reset()
        out = WI.add_wide(pk, ctx_k, bk_k, WI.encrypt_wide(sk_k, g_k, xv_k, 2),
                          WI.encrypt_wide(sk_k, g_k, yv_k, 2))
        noise_ = wide_right(f"k={k} add_wide", sk_k, out, xv_k + yv_k)
        print(f"[10] k={k} add_wide of 64 2-digit pairs: every value right, max |phase "
              f"noise| {noise_}; launches {counts()}")
        tag = f"s2 k={k}"
        time_kernels(tag, pk, ctx_k, bk_k, 2 * pairs, "sgfhe_tpu/ops/fused.py:604",
                     phase="10", reps=steps_timed)
        check_steps("10", tag, pk, ctx_k, bk_k, (128,))
        runs10[tag] = (l_k, 2, tr_k)
        del bk_k, sk_k, ctx_k, lx, ly, out
        torch.cuda.empty_cache()
    print(f"[10] -Xptxas -v, flatten_ntt_fwd at L=4 randomized: "
          f"{ptxas_entry(ptxas_text, 'flatten_ntt_fwd_kernelILi4ELb1E')}")
    print(f"[10] peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    phase_done("10")

    # ---- 11. Params(1024) served end to end through the wire --------------------
    def same(x, y):
        return all(torch.equal(getattr(x, f), getattr(y, f)) for f in ("a", "b"))

    p1k = T.Params.create(1024)
    ctx1k = T.make_context(p1k, device=dev)
    key_bytes = 2 * p1k.n * 2 * p1k.num_digits * 2 * p1k.num_limbs * p1k.m * 4
    free = torch.cuda.mem_get_info()[0]
    if free < 2 * key_bytes + 8 * KEY_CHUNK_BYTES:
        fail(f"[11] {free / 2**30:.1f} GiB free, the key and its loaded copy need "
             f"{2 * key_bytes / 2**30:.1f} GiB and the builders' chunks")
    g1k = torch.Generator().manual_seed(16)
    sk1k = T.PrivateKey.create(p1k, g1k, device=dev)
    bk1k, s_key = timed_s(T.BootstrapKey.create, ctx1k, sk1k, g1k)
    print(f"[11] Params(1024): m={p1k.m} L={p1k.num_limbs} moduli={p1k.moduli}; key with "
          f"Shoup companions made on the card in {s_key:.1f} s: "
          f"{2 * bk1k.hat.numel() * 4 / 2**20:.0f} MiB ({free / 2**30:.1f} GiB free before)")
    raw_sk, s_sk = timed_s(S.to_wire, sk1k)
    raw_bk, s_to = timed_s(S.bootstrap_key_to_wire_seeded, bk1k)
    sk_w = S.from_wire(raw_sk, ctx1k)
    bk_w, s_from = timed_s(S.from_wire, raw_bk, ctx1k)
    if not torch.equal(sk_w.key, sk1k.key):
        fail("[11] the private key frame loads another key")
    if not (torch.equal(bk_w.hat, bk1k.hat) and torch.equal(bk_w.hat_shoup, bk1k.hat_shoup)):
        fail("[11] the seeded bootstrap-key frame loads another key")
    mb = len(raw_bk) / 1e6
    print(f"[11] frames: private key {len(raw_sk)} bytes; seeded bootstrap key "
          f"{len(raw_bk)} bytes ({len(raw_bk) / 2**20:.1f} MiB, seed and "
          f"{max(q.bit_length() for q in p1k.moduli)}-bit b-column)")
    print(f"[11] seeded key to_wire {s_to:.3f} s ({mb / s_to:.1f} MB/s), from_wire on the "
          f"card {s_from:.3f} s ({mb / s_from:.1f} MB/s: CRC, unpack, a-column drawn again, "
          f"forward NTT, companions); loaded key == original bit for bit (hat and hat_shoup)")
    del bk1k
    torch.cuda.empty_cache()
    m1 = torch.randint(0, 2, (p1k.n,), generator=g1k)
    m2 = torch.randint(0, 2, (p1k.n,), generator=g1k)
    cts = [S.from_wire(S.to_wire(T.encrypt(sk1k, g1k, m)), ctx1k) for m in (m1, m2)]
    lwe1, lwe2 = (T.split_ciphertext(ct).lwe for ct in cts)
    y1, y2 = m1.to(dev).bool(), m2.to(dev).bool()
    out1k, l1k, tr1k = drive("11", p1k, ctx1k, bk_w, sk_w, lwe1, lwe2, y1, y2, reps=3)
    rnd1k = T.bootstrap_batch(p1k, ctx1k, bk_w.hat, bk_w.hat_shoup, lwe1, lwe2, SEED2)
    for mode, out in (("deterministic", out1k), ("randomized", rnd1k)):
        back = [S.from_wire(S.to_wire(T.EncryptedBit(lwe)), ctx1k).lwe for lwe in out]
        if not all(same(x, y) for x, y in zip(back, out)):
            fail(f"[11] {mode}: EncryptedBit frames change the gates' outputs")
        truth_tables(sk_w, back, y1, y2)
        print(f"[11] {mode}: {p1k.n} gates' AND/OR/XOR sent back as EncryptedBit frames, all "
              f"{3 * p1k.n} outputs decrypt right with the loaded private key")
    time_kernels("n=1024", p1k, ctx1k, bk_w, p1k.n, "sgfhe_tpu/ops/fused.py:604", phase="11")
    check_steps("11", "n=1024", p1k, ctx1k, bk_w, (p1k.n,))
    print(f"[11] peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    # phase 15 serves the same key and gates through the multi-device layer
    p11 = dict(bk=bk_w, sk=sk_w, out=out1k, lwe1=lwe1, lwe2=lwe2, y1=y1, y2=y2)
    del bk_w, out1k, rnd1k
    torch.cuda.empty_cache()
    # the phase-6 scheme-2 key through its seeded frame (stream 2)
    raw2, s_to2 = timed_s(S.bootstrap_key_to_wire_seeded, bk2)
    bk2_w, s_from2 = timed_s(S.from_wire, raw2, ctx2)
    if not (torch.equal(bk2_w.hat, bk2.hat) and torch.equal(bk2_w.hat_shoup, bk2.hat_shoup)):
        fail("[11] the scheme-2 seeded frame loads another key")
    del bk2_w
    print(f"[11] scheme 2 k={s2p.k} n={s2p.n} seeded key frame {len(raw2)} bytes "
          f"({s2p.n // min(s2p.n, 128)} chunks of stream 2): to_wire {s_to2:.3f} s, from_wire "
          f"{s_from2:.3f} s, loaded key == original bit for bit")
    # every other frame type once at Params(64), and an npz checkpoint
    pk64 = T.PublicKey.create(ctx64, sk64, g64)
    msg = torch.randint(0, 2, (p64.n,), generator=g64)
    ct64 = T.encrypt(sk64, g64, msg)
    bits64 = T.split_ciphertext(ct64)
    small = [
        ("private key", sk64, lambda o: [o.key]),
        ("public key", pk64, lambda o: [o.k0, o.k1]),
        ("bootstrap key", bk64, lambda o: [o.hat, o.hat_shoup]),
        ("packed ciphertext", ct64, lambda o: [o.rlwe.a, o.rlwe.b]),
        ("ciphertext", T.pack_encrypted_bits(p64, ctx64, bk64, bits64), lambda o: [o.rlwe.a,
                                                                                     o.rlwe.b]),
        ("encrypted bits", bits64, lambda o: [o.lwe.a, o.lwe.b]),
        ("private space-optimal", T.encrypt_optimal(sk64, g64, msg), lambda o: [o.u, o.v]),
        ("public space-optimal", T.encrypt_optimal(pk64, ctx64, g64, msg),
         lambda o: [o.a_bits, o.b_bits]),
    ]
    for name, obj, fields in small:
        back = S.from_wire(S.to_wire(obj), ctx64)
        if not all(torch.equal(x, y) for x, y in zip(fields(obj), fields(back))):
            fail(f"[11] {name} frame at Params(64) loads another object")
        if name.endswith("ciphertext") and not torch.equal(T.decrypt(sk64, back),
                                                           msg.to(dev).bool()):
            fail(f"[11] {name} frame decrypts wrong")
    x2 = torch.randint(0, 2**s2p.k, (s2p.n,), generator=g2)
    p2w, a2w, b2w = S.from_wire(S.s2_ciphertext_to_wire(s2p, *S2.encrypt(sk2, g2, x2)), ctx2)
    if p2w != s2p or not torch.equal(S2.decrypt(sk2, a2w, b2w), x2.to(dev)):
        fail("[11] scheme-2 ciphertext frame decrypts wrong")
    lw = B2.split_ciphertext(s2p, a2w, b2w)
    if not same(S.from_wire(S.s2_lwe_to_wire(s2p, lw), ctx2)[1], lw):
        fail("[11] scheme-2 LWE frame loads another batch")
    ckpt = ROOT / "build" / "chip_smoke_bkey64.npz"
    S.save(ckpt, bk64)
    bk64_c = S.load(ckpt, device=dev)
    ckpt.unlink()
    if not (torch.equal(bk64_c.hat, bk64.hat) and torch.equal(bk64_c.hat_shoup, bk64.hat_shoup)):
        fail("[11] npz checkpoint loads another key")
    print(f"[11] Params(64): {len(small)} frame types and the two scheme-2 frames round-trip "
          f"equal on the card (ciphertexts decrypt right); npz checkpoint of the key equal")
    phase_done("11")

    # ---- 12/13. scheme 2 at k = 3 and k = 5, n = 1024 ---------------------------
    # k = 3: Params(1024)'s kernel shape at 512 pairs (1024 lanes)
    p3, ctx3, sk3, bk3, g3 = s2_keys("12", 3, 18)
    lx, ly, x, y = s2_pairs(p3, sk3, g3, 512)
    s2_add("12", p3, ctx3, bk3, sk3, lx, ly, x + y, 2)
    trace("12", lambda: B2.add_with_carry(p3, ctx3, bk3, lx, ly))
    s2_add("12", p3, ctx3, bk3, sk3, lx, ly, x + y, 1, seed_words=SEED2)
    s2_add("12", p3, ctx3, bk3, sk3, lx, ly, x + y, 1, prune=2)
    Bm = 128
    mx, my = T.LWE(lx.a[:Bm], lx.b[:Bm]), T.LWE(ly.a[:Bm], ly.b[:Bm])
    s2_add("12", p3, ctx3, bk3, sk3, mx, my, x[:Bm] * y[:Bm], 1, rounds=3)
    check_steps("12", "s2 k=3", p3, ctx3, bk3, (1024, 4 * Bm, 2 * Bm, Bm))
    check_steps("12", "s2 k=3", p3, ctx3, bk3, (1024,), prune=2)
    twin_ops("12", p3, ctx3, bk3, T.LWE(lx.a[:4], lx.b[:4]), T.LWE(ly.a[:4], ly.b[:4]))
    del bk3, lx, ly, mx, my
    torch.cuda.empty_cache()
    phase_done("12")

    # k = 5: m = 32768, the kernels' MAX_M, and its 16 GiB key
    p5, ctx5, sk5, bk5, g5 = s2_keys("13", 5, 20)
    lx, ly, x, y = s2_pairs(p5, sk5, g5, 256)
    # the traced call is the warm one: a call takes 12 s here
    tr_k5 = trace("13", lambda: B2.add_with_carry(p5, ctx5, bk5, lx, ly))
    l_k5 = s2_add("13", p5, ctx5, bk5, sk5, lx, ly, x + y, 2, warm=False)
    sx, sy = T.LWE(lx.a[:32], lx.b[:32]), T.LWE(ly.a[:32], ly.b[:32])
    s2_add("13", p5, ctx5, bk5, sk5, sx, sy, x[:32] + y[:32], 1, seed_words=SEED2)
    s2_add("13", p5, ctx5, bk5, sk5, sx, sy, x[:32] + y[:32], 1, prune=1)
    time_kernels("s2 k=5", p5, ctx5, bk5, 512, "sgfhe_tpu/ops/fused.py:604", phase="13",
                 reps=256)
    check_steps("13", "s2 k=5", p5, ctx5, bk5, (64,))
    check_steps("13", "s2 k=5", p5, ctx5, bk5, (64,), prune=1)
    print(f"[13] peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    del bk5, lx, ly, sx, sy
    torch.cuda.empty_cache()
    phase_done("13")

    # ---- 14. the single-card examples, in-process on the card --------------------
    from sgfhe_tpu_torch.examples import adder, depth

    reset()
    t = time.perf_counter()
    with CountRotations() as rot14:
        summed = adder.main(["8", "64", "4"])
        soak = depth.main(["10", "64"])
    torch.cuda.synchronize()
    ex_s = time.perf_counter() - t
    what = expect_launches("14", p64, rot14.n)
    print(f"[14] examples adder (8 bits, n=64, {len(summed['pairs'])} instances: every sum "
          f"right) and depth ({soak['generations']} generations, n=64: every gate right, max "
          f"|noise| {soak['max_err']}) in {ex_s:.1f} s; {rot14.n} rotations, launches {what}")
    phase_done("14")

    # ---- 15. the multi-device layer (parallel/) at world size 1 over NCCL -------
    import torch.distributed as dist
    from sgfhe_tpu_torch.examples import scaling, scheme2_dist
    from sgfhe_tpu_torch.parallel import distributed as PD
    from sgfhe_tpu_torch.parallel import mesh as PM
    from sgfhe_tpu_torch.parallel import rotate_dist as RD
    from sgfhe_tpu_torch.parallel import sharded as PS

    PD.init_world(dev)
    if dist.get_backend() != "nccl" or dist.get_world_size() != 1:
        fail(f"[15] process group {dist.get_backend()} of {dist.get_world_size()} ranks")
    print(f"[15] world size {dist.get_world_size()} over {dist.get_backend()}")
    mesh = PM.make_mesh(dp=1, tp=1)
    bk, sk_w, lwe1, lwe2 = p11["bk"], p11["sk"], p11["lwe1"], p11["lwe2"]
    # (a) data-parallel: Params(1024)'s 1024 gates through bootstrap_internal's kernels
    out_dp, launches, med, times = timed(
        "15a", lambda: PS.bootstrap_batch_sharded(p1k, ctx1k, bk, lwe1, lwe2, mesh), 2)
    want = p1k.n * 3
    if launches != (want, want):
        fail(f"[15a] launches {launches}, expected 2n per call = {want} each")
    if not all(same(x, y) for x, y in zip(out_dp, p11["out"])):
        fail("[15a] bootstrap_batch_sharded != bootstrap_batch")
    truth_tables(sk_w, out_dp, p11["y1"], p11["y2"])
    print(f"[15a] bootstrap_batch_sharded on the (1, 1) mesh, {p1k.n} gates at Params(1024): "
          f"== bootstrap_batch bit for bit, truth tables AND/OR/XOR hold; launches "
          f"(flatten_ntt_fwd, mac_rotate_ntt_inv) = {launches} over 3 calls")
    print(f"[15a] {p1k.n / med:.1f} gates/s (median of 2: {[round(t, 4) for t in times]} s), "
          f"phase 11's bootstrap_batch {rates['11']:.1f} gates/s, on {card}")
    # (b) tensor-parallel: the four-step rotation through all n steps, 8 gates
    torch.cuda.reset_peak_memory_stats()
    rplan = RD.build_rotation_plan(p1k.moduli, 64, 128, dev)
    hat_d, s_conv = timed_s(RD.bkey_to_dist, ctx1k, rplan, bk.hat)
    print(f"[15b] bkey_to_dist at (m1, m2) = (64, 128): {s_conv:.2f} s for the "
          f"{2 * bk.hat.numel() * 4 / 2**20:.0f} MiB key (hat and Shoup companions), "
          f"{hat_d.numel() * 4 / 2**20:.0f} MiB in the dist order")
    g8 = [T.LWE(w.a[:8], w.b[:8]) for w in (lwe1, lwe2)]
    for mode, kw in (("exact", {}), ("randomized", dict(seed_words=SEED2, epoch=0))):
        want = T.bootstrap_batch(p1k, ctx1k, bk.hat, bk.hat_shoup, *g8, **kw)
        got, s_tp = timed_s(lambda: RD.bootstrap_batch_tp(p1k, ctx1k, rplan, mesh, hat_d,
                                                          *g8, **kw))
        if not all(same(x, y) for x, y in zip(got, want)):
            fail(f"[15b] {mode}: bootstrap_batch_tp != the kernel route's bootstrap_batch")
        truth_tables(sk_w, got, p11["y1"][:8], p11["y2"][:8])
        print(f"[15b] {mode}: bootstrap_batch_tp on 8 gates through all {p1k.n} steps in "
              f"{s_tp:.2f} s ({s_tp / p1k.n * 1e3:.2f} ms a step) on {card}; == the kernel "
              f"route's bootstrap_batch bit for bit, truth tables hold")
    print(f"[15b] peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    del hat_d, p11, bk, out_dp
    torch.cuda.empty_cache()
    # (c) scheme 2 at k = 4 through add_with_carry_dist (the example at its defaults)
    p4 = S2.Params.create(4)
    # the key with its Shoup companions, and its dist-order copy without them
    need = 3 * fused.fused_bkey_bytes(p4) // 2 + 8 * KEY_CHUNK_BYTES
    free = torch.cuda.mem_get_info()[0]
    if free < need:
        fail(f"[15c] {free / 2**30:.1f} GiB free, the k=4 key and its dist-order copy need "
             f"{need / 2**30:.1f} GiB")
    ex, s_ex = timed_s(scheme2_dist.main, ["4", "2", "0"])
    print(f"[15c] scheme2_dist 4 2 0 in {s_ex:.1f} s: key {ex['keygen_s']:.1f} s, bkey_to_dist "
          f"{ex['convert_s']:.1f} s, add_with_carry_dist {ex['add_s']:.1f} s "
          f"({ex['add_s'] / p4.n * 1e3:.2f} ms a step, 4 lanes) on {card}")
    for prune in (0, 1):
        if prune:
            ex["key_dist"] = None
            torch.cuda.empty_cache()
            key_p = RD.bkey_to_dist(ex["ctx"], ex["rplan"], ex["bkey"].hat, prune)
            got, s_p = timed_s(lambda: RD.add_with_carry_dist(
                ex["params"], ex["ctx"], ex["rplan"], mesh, key_p, ex["lx"], ex["ly"],
                prune=prune))
        else:
            got, s_p = (ex["digit"], ex["carry"]), ex["add_s"]
        want = B2.add_with_carry(ex["params"], ex["ctx"], ex["bkey"], ex["lx"], ex["ly"],
                                 prune=prune)
        if not all(same(x, y) for x, y in zip(got, want)):
            fail(f"[15c] prune={prune}: add_with_carry_dist != the kernel route's add_with_carry")
        z = ex["z"]
        noise_ = max(digits_noise("15c digit", ex["sk"], got[0], z % 16),
                     digits_noise("15c carry", ex["sk"], got[1], z // 16))
        print(f"[15c] k=4 prune={prune}: add_with_carry_dist ({s_p:.1f} s) == the kernel "
              f"route's add_with_carry bit for bit on {z.numel()} pairs; every digit and "
              f"carry right, max |phase noise| {noise_}")
    print(f"[15c] peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    del ex, key_p, got, want
    torch.cuda.empty_cache()
    # (d) the scaling harness at its defaults, on the world of one card
    reset()
    with CountRotations() as rot15:
        rows = scaling.main(["256", "64"])
    what = expect_launches("15d", T.Params.create(64), rot15.n)
    print(f"[15d] scaling 256 64: (devices, gates/s, efficiency) = {rows} on {card}; "
          f"{rot15.n} rotations, launches {what}")
    dist.destroy_process_group()
    phase_done("15")
    print(f"[total] build and phases {time.perf_counter() - t_start:.1f} s")

    # On the rows of the modes a main path runs: launches, the kernel's count
    # in that path's run, calls, the number of calls in the run, and
    # trace_ms, its device ms per launch in the traced call. The other modes
    # launched 0 times there.
    runs = {"n=512": (l512, 3, tr512), "s2 k=1": (l_add, 3, tr_s2), **runs10,
            "n=1024": (l1k, 4, tr1k), "s2 k=5": (l_k5, 2, tr_k5)}
    for row in table:
        tag = row["name"][row["name"].index("(") + 1:-1]
        if row["name"].startswith("rotate_resident"):  # Params(64)'s main path, phase 4
            mode = row["name"][len("rotate_resident "):row["name"].index(" (")]
            row.update(launches=l64[mode], calls=calls64[mode],
                       trace_ms=tr64["rotate_resident"] if mode == "exact" else None)
            continue
        if tag == "n=64":  # the step pair at Params(64): phase 4's comparison route
            row.update(launches=0, calls=0, trace_ms=None)
            continue
        counts_, calls, tr = runs[tag]
        fwd = row["name"].startswith("flatten")
        kname = "flatten_ntt_fwd" if fwd else "mac_rotate_ntt_inv"
        main = row["name"] == f"{kname} ({tag})"
        row["launches"] = (counts_[0] if fwd else counts_[1]) if main else 0
        row["calls"] = calls if main else 0
        row["trace_ms"] = tr[kname] if main else None
    print(f"[card] {smi()}")
    print(json.dumps({"kernels": table + switch_table}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
